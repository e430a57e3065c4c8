"""The control comes out not correct: the reference computed a step below
each precision the configuration states (TF32 for its float32 sums, the
UNets' bfloat16 convolutions without the one rounding, the vertices in
bfloat16), in the program's place, fails at least one of the cell's
numbers against the reference (benchmark/control.py)."""

import pytest
import torch

from benchmark import control
from benchmark.harness import spec as S
from benchmark.tests import tiny

BENCH = S.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


def _fails(workload, readings):
    limits = S.config(BENCH, S.cell(BENCH, workload)["config"])["limits"]
    return [n for n, v in readings.items() if v > limits[n]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    torch.set_num_threads(4)
    got = control.readings(cell, 2**32 + 3, torch.device("cpu"),
                           tiny.overrides(cell), program=False,
                           controls=("all",))
    numbers = got["all"]["numbers"]
    assert _fails(cell, numbers), numbers


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    got = control.readings("mesh_unet.batch8", 2**32 + 5, card,
                           program=False, controls=("all",))
    numbers = got["all"]["numbers"]
    assert _fails("mesh_unet.batch8", numbers), numbers
