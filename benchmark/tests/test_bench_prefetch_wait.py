"""metrics/prefetch_wait_ms.py: the cohort's wait for its prefetch worker,
read from the port's always-on counters after a traced run, at a tiny
size on the CPU."""

from benchmark.harness import spec as S
from benchmark.metrics import prefetch_wait_ms
from benchmark.tests import tiny


def test_traced_cohort_reads_the_prefetch_wait():
    from shoulder_tpu_torch.utils import trace

    trace.reset()
    result, correct = tiny.run("mesh_unet.cohort64", trace=True)
    assert correct
    names = {m["name"] for m in S.per_layer(S.load_benchmark(),
                                            "mesh_unet.cohort64")}
    assert result["metrics"]["prefetch_wait_ms.cohort"]["value"] > 0
    assert set(result["metrics"]) <= names
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_the_counters_nothing_is_read():
    from shoulder_tpu_torch.utils import trace

    trace.reset()
    assert prefetch_wait_ms.read({}) is None
