"""metrics/graph_hit_share.py: the share of stage calls that replayed a
CUDA graph, read from the port's always-on counters after a run."""

from benchmark.harness import spec as S
from benchmark.metrics import graph_hit_share


def test_reads_replays_over_all_stage_calls():
    from shoulder_tpu_torch.utils import trace

    trace.reset()
    try:
        trace.count("graphs.replays", 99)
        trace.count("graphs.eager", 1)
        trace.count("graphs.captures", 11)
        assert graph_hit_share.read({}) == 0.99
    finally:
        trace.reset()


def test_without_the_counters_nothing_is_read():
    from shoulder_tpu_torch.utils import trace

    trace.reset()
    assert graph_hit_share.read({}) is None


def test_entries_name_the_reader_and_their_cells():
    bench = S.load_benchmark()
    for name, cell in (("graph_hit_share.batch8", "mesh_unet.batch8"),
                       ("graph_hit_share.single", "mesh_unet.single")):
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [cell]
        assert S.reader_of(name)[0] is graph_hit_share
