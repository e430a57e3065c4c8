"""Each cell's mix end to end at a tiny size on the CPU: set-up, the
window, the reference, the result; with --trace 1 for one cell."""

import json

import pytest

from benchmark.harness import compare
from benchmark.harness import spec as S
from benchmark.tests import tiny

CELLS = [c["name"] for c in S.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_mix_runs_and_is_correct(cell):
    result, correct = tiny.run(cell)
    assert correct and result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    names = {m["name"] for m in S.end_to_end(S.load_benchmark(), cell)}
    assert set(result["metrics"]) == names
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(compare.NUMBERS)
    json.dumps(result)


def test_traced_run_reads_per_layer_metrics():
    result, correct = tiny.run("mesh_unet.batch8", trace=True)
    assert correct
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in S.per_layer(S.load_benchmark(),
                                            "mesh_unet.batch8")}
    assert set(result["metrics"]) <= names
    assert "anp_host_ms.batch8" in result["metrics"]
