"""metrics/ingest_overlap_share.py: the share of the cohort's bones whose
ingest overlapped another's, read from the port's always-on counters
after a traced run, at a tiny size on the CPU."""

from benchmark.harness import spec as S
from benchmark.metrics import ingest_overlap_share
from benchmark.tests import tiny


def test_traced_cohort_reads_the_overlap_share():
    from shoulder_tpu_torch.utils import trace

    trace.reset()
    result, correct = tiny.run("mesh_unet.cohort64", trace=True)
    assert correct
    names = {m["name"] for m in S.per_layer(S.load_benchmark(),
                                            "mesh_unet.cohort64")}
    share = result["metrics"]["ingest_overlap_share.cohort"]
    assert share["unit"] == "share" and 0 <= share["value"] <= 1
    assert set(result["metrics"]) <= names


def test_the_share_is_the_counters_ratio():
    from shoulder_tpu_torch.utils import trace

    trace.reset()
    assert ingest_overlap_share.read({}) is None
    trace.count("cohort.bones_ingested", 8)
    assert ingest_overlap_share.read({}) is None
    trace.count("cohort.ingest_overlap", 0)
    assert ingest_overlap_share.read({}) == 0.0
    trace.count("cohort.ingest_overlap", 6)
    assert ingest_overlap_share.read({}) == 0.75
    trace.reset()
