"""Rigid-frame invariance of the port: tests/test_rigid_invariance.py's
bone under its 6 rigid frames from `default_rng(42)` (chip_smoke's
`rigid_meshes`, which phase 14a runs on the card).

The port's ingest must equal the JAX package's bit for bit in every frame
(the OBB search and the presort are where the frame enters), and the
frames, one batch, must meet the JAX test's gates as written: the spread
of neck-shaft angle, retroversion and head radius each below 0.5, no
side flip, anatomic-neck plane points mapped back to the build frame
within 1.0 mm and normals within 0.5 deg.  Tier-1 runs the batch at
tiny_config's slice widths with the padding of the full bone (a few
seconds on one thread); the `slow` cases run it at DEFAULT_CONFIG with
the shipped UNet, as the JAX test does, and hold each frame within
bench.py's 0.75 deg / 0.75 mm of the JAX package's result for it.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from shoulder_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from shoulder_tpu.config import tiny_config as jax_tiny_config
from shoulder_tpu.io import ingest as jax_ingest
from shoulder_tpu.io import stl as jax_stl
from shoulder_tpu.pipeline import batch as jbatch
from shoulder_tpu_torch.config import DEFAULT_CONFIG, tiny_config
from shoulder_tpu_torch.models import forest, unet
from shoulder_tpu_torch.pipeline import batch as tbatch

N_FRAMES = chip_smoke.RIGID_FRAMES
SIZES = dict(max_faces=40960, max_verts=24576)
CONFIGS = {"tiny": tiny_config(**SIZES), "default": DEFAULT_CONFIG}
CASES = ["tiny", pytest.param("default", marks=pytest.mark.slow)]
SPEC_FIELDS = ("obb_transform", "vertices", "faces", "neighbors",
               "face_orig", "z_bounds", "cutoff_pcts")
METRICS = ("neckshaft", "retroversion", "radius_curvature")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return chip_smoke.rigid_meshes()


@pytest.fixture(scope="module")
def batches(frames):
    """The frames' landmarks (numpy) at a config of CONFIGS, one batch,
    computed once per config."""
    done = {}

    def get(name):
        if name not in done:
            cfg = CONFIGS[name]
            seg = unet.load_model("cpu") if cfg.segmenter == "unet" else None
            specs = chip_smoke.rigid_specs(*frames, cfg)
            done[name] = tbatch.landmarks_to_numpy(
                tbatch.compute_landmarks_batch(
                    tbatch.stack_bones(specs, "cpu"),
                    forest.load_params("cpu"), cfg=cfg, seg_model=seg))
        return done[name]
    return get


@pytest.mark.parametrize("i", range(N_FRAMES))
def test_ingest_matches_jax_bit_for_bit(frames, i):
    (_, _, v), faces = frames[0][i], frames[1]
    got = chip_smoke.rigid_specs([frames[0][i]], faces, CONFIGS["tiny"])[0]
    nbr, wt = jax_stl.edge_face_adjacency(faces)
    want = jax_ingest.spec_from_arrays(f"frame{i}", v, faces, nbr, wt,
                                       config=jax_tiny_config(**SIZES))
    for name in SPEC_FIELDS:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("name", CASES)
def test_metrics_frame_invariant(batches, name):
    lm = batches(name)
    ns, rv, rad = (np.asarray(getattr(lm, m)) for m in METRICS)
    assert np.isfinite(ns).all() and np.isfinite(rv).all()
    assert np.ptp(ns) < 0.5, f"neckshaft across frames: {np.round(ns, 3)}"
    assert np.ptp(rv) < 0.5, f"retroversion across frames: {np.round(rv, 3)}"
    assert np.ptp(rad) < 0.5, f"radius across frames: {np.round(rad, 3)}"
    assert not np.asarray(lm.side_is_left).any(), "side flipped under rigid"


@pytest.mark.parametrize("name", CASES)
def test_landmarks_map_back(frames, batches, name):
    lm = batches(name)
    pts, normals = [], []
    for i, (rot, t, _) in enumerate(frames[0]):
        p = (np.asarray(lm.anp_plane_point[i]) - t) @ rot
        n = np.asarray(lm.anp_plane_normal[i]) @ rot
        n = n if n[2] >= 0 else -n
        pts.append(p)
        normals.append(n)
    pts, normals = np.stack(pts), np.stack(normals)
    assert np.ptp(pts, axis=0).max() < 1.0, f"plane points:\n{pts}"
    ref = normals[0]
    angles = []
    for n in normals[1:]:
        ang = np.degrees(np.arccos(np.clip(np.dot(ref, n), -1, 1)))
        assert ang < 0.5, f"plane normal drift {ang:.3f} deg"
        angles.append(ang)
    # chip_smoke's gate (phase 14a) measures the same
    spread = chip_smoke.rigid_spread(frames[0], lm)
    assert spread["point_ptp"] == np.ptp(pts, axis=0).max()
    assert spread["normal_deg"] == max(angles)
    assert chip_smoke.rigid_failures(spread) == []


@pytest.mark.slow
def test_default_frames_match_jax(frames, batches):
    """Each frame within bench.py's 0.75 deg / 0.75 mm of the JAX
    package's landmarks for it at DEFAULT_CONFIG."""
    faces = frames[1]
    nbr, wt = jax_stl.edge_face_adjacency(faces)
    specs = [jax_ingest.spec_from_arrays(f"frame{i}", v, faces, nbr, wt,
                                         config=JAX_DEFAULT_CONFIG)
             for i, (_, _, v) in enumerate(frames[0])]
    want = jbatch.landmarks_to_numpy(jbatch.compute_landmarks_batch(
        jbatch.stack_bones(specs), chunk=150))
    got = batches("default")
    assert np.array_equal(got.side_is_left, np.asarray(want.side_is_left))
    for m in METRICS:
        diff = np.abs(np.asarray(getattr(got, m), np.float64)
                      - np.asarray(getattr(want, m), np.float64))
        assert (diff < 0.75).all(), (m, diff)
