"""The dense mesh cell end to end on the CPU at a small size, its mesh
past the small padding (benchmark/tests/dense.py): the port's plain paths
against the reference."""

from benchmark.harness import spec as S
from benchmark.tests import dense


def test_dense_cell_runs_and_is_correct():
    result, correct = dense.run("cpu")
    assert correct and result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    names = {m["name"] for m in S.end_to_end(S.load_benchmark(), dense.CELL)}
    assert set(result["metrics"]) == names == {"bones_per_s",
                                               "latency_p95_ms", "setup_s"}
