"""Both CT pitches of tests/test_ct_pitch_sweep.py, and the 2.0 mm row of
tools/eval_ct_pitch.py, through the port on the CPU.

The same synthetic bone as its direct mesh (220 rings of 192) and as a
CT volume at 1.0 and 1.5 mm (seed 1, 15 HU noise) cut at 300 HU, marched
and welded by the port (chip_smoke's `pitch_mesh_spec` / `pitch_ct_spec`,
which phase 14c runs on the card), one batch of 2 at
tools/eval_ct_pitch.py's config (tiny_config's stacks, band 6144, k
1024).  The CT-vs-mesh deltas must stay inside that test's `BOUNDS`, the
side must agree, and each delta (neck_z's too) must lie within 0.01 of
the JAX package's row in tools/eval_ct_pitch_results.json.  At 2.0 mm
(a 160 x 72 x 72 volume) that test sets no bound and the JAX row calls
the side wrong: the port must do the same, each delta within 0.01 of the
row.  A `slow` case runs tools/eval_ct_pitch_torch.py's three rows.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from shoulder_tpu_torch.models import forest
from shoulder_tpu_torch.pipeline import batch as tbatch

CFG = chip_smoke.pitch_config()
ROW_TOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return chip_smoke.pitch_mesh_spec(CFG)


@pytest.mark.parametrize("pitch", sorted(chip_smoke.PITCH_BOUNDS))
def test_pitch_deltas_within_measured_envelope(mesh, pitch):
    ct = chip_smoke.pitch_ct_spec(pitch, CFG, "cpu")
    assert ct.watertight
    lm = tbatch.landmarks_to_numpy(tbatch.compute_landmarks_batch(
        tbatch.stack_bones([mesh, ct], "cpu"), forest.load_params("cpu"),
        cfg=CFG, chunk=16))
    assert not lm.qc_slice_overflow.any()
    assert lm.side_is_left[0] == lm.side_is_left[1]
    d, row = chip_smoke.pitch_deltas(lm), chip_smoke.pitch_row(pitch)
    for key, bound in chip_smoke.PITCH_BOUNDS[pitch].items():
        assert abs(d[f"d_{key}"]) < bound, (pitch, key, d)
    for key in d:
        assert np.isfinite(d[key]) and abs(d[key] - row[key]) <= ROW_TOL, (
            pitch, key, d[key], row[key])


def _batch_of(mesh, ct):
    return tbatch.landmarks_to_numpy(tbatch.compute_landmarks_batch(
        tbatch.stack_bones([mesh, ct], "cpu"), forest.load_params("cpu"),
        cfg=CFG, chunk=16))


def test_pitch_2mm_row_matches_jax(mesh):
    """The 2.0 mm row: no envelope (tests/test_ct_pitch_sweep.py sets
    none), the side as the JAX row calls it (wrong), every delta within
    ROW_TOL of the row."""
    ct = chip_smoke.pitch_ct_spec(2.0, CFG, "cpu")
    assert ct.watertight
    lm = _batch_of(mesh, ct)
    row = chip_smoke.pitch_row(2.0)
    assert not lm.qc_slice_overflow.any()
    assert bool(lm.side_is_left[0] == lm.side_is_left[1]) == row["side_ok"]
    d = chip_smoke.pitch_deltas(lm)
    for key in d:
        assert np.isfinite(d[key]) and abs(d[key] - row[key]) <= ROW_TOL, (
            key, d[key], row[key])


@pytest.mark.slow
def test_eval_ct_pitch_tool_rows(tmp_path):
    """tools/eval_ct_pitch_torch.py at its default pitches on the CPU: its
    reference and rows against the JAX tool's JSON within ROW_TOL, each
    side_ok equal."""
    tool = chip_smoke.load_tool("eval_ct_pitch_torch")
    out = tmp_path / "rows.json"
    ref, rows = tool.main(["--device", "cpu", "--out", str(out)])
    want = chip_smoke.tool_json("eval_ct_pitch_results.json")
    assert json.loads(out.read_text())["rows"] == rows
    for key in want["reference"]:
        assert abs(ref[key] - want["reference"][key]) <= ROW_TOL, key
    assert [r["pitch_mm"] for r in rows] == [1.0, 1.5, 2.0]
    for got, row in zip(rows, want["rows"]):
        assert got["side_ok"] == row["side_ok"]
        for key in ("d_ns", "d_rv", "d_rad", "d_neck_z"):
            assert abs(got[key] - row[key]) <= ROW_TOL, (row["pitch_mm"],
                                                        key)
