"""The port's parallel/mesh.py vs shoulder_tpu's, on the CPU.

Meshes of CPU devices stand in for cards here (`bone_mesh` takes the
devices it is given); each shard runs the batched pipeline at tiny_config
with the plain slice stack.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoulder_tpu.parallel import mesh as jmesh
from shoulder_tpu_torch import cohort as tcohort
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.io import ingest, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.parallel import mesh as tmesh
from shoulder_tpu_torch.pipeline import batch as tbatch
from shoulder_tpu_torch.pipeline import landmarks as tlm

CFG = tiny_config()
CPU = torch.device("cpu")
STATS = namedtuple("STATS", "retroversion neckshaft radius_curvature "
                            "side_is_left")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    out = []
    for i, side in enumerate(("right", "left", "left", "right")):
        v, f = synthetic_humerus(side=side, n_rings=40, n_theta=32,
                                 rng_transform=np.random.default_rng(30 + i))
        out.append(d / f"bone{i}.stl")
        stl.write_stl(out[-1], v, f)
    return out


@pytest.fixture(scope="module")
def bones(paths):
    return tbatch.stack_bones([ingest.load_bone(p, config=CFG) for p in paths],
                              CPU)


@pytest.fixture(scope="module")
def unsharded(bones):
    return tbatch.compute_landmarks_batch(bones, cfg=CFG)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_batch_equals_unsharded(bones, unsharded, n_dev):
    mesh = tmesh.bone_mesh([CPU] * n_dev)
    shards = tmesh.shard_bones(bones, mesh)
    assert [s.verts.shape[0] for s in shards] == [4 // n_dev] * n_dev
    out = tmesh.sharded_landmark_fn(mesh, cfg=CFG)(shards)
    assert len(out) == n_dev
    for name in tlm.Landmarks._fields:
        got = torch.cat([getattr(lm, name) for lm in out])
        assert torch.equal(got.nan_to_num(),
                           getattr(unsharded, name).nan_to_num()), name


def test_shard_bones_needs_an_even_split(bones):
    with pytest.raises(ValueError, match="split"):
        tmesh.shard_bones(bones, tmesh.bone_mesh([CPU] * 3))


def test_bone_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.bone_mesh()
    assert tmesh.bone_mesh(["cpu", "cpu"]).devices == (CPU, CPU)


def _jax_stats(x):
    ref = jmesh.cohort_stats(STATS(*(jnp.asarray(a) for a in x)),
                             jmesh.bone_mesh(jax.devices()[:1]))
    return {k: float(v) for k, v in ref.items()}


def _cases():
    rng = np.random.default_rng(7)
    retro = rng.normal(25.0, 8.0, 8).astype(np.float32)
    ns = rng.normal(135.0, 4.0, 8).astype(np.float32)
    rad = rng.normal(24.0, 1.5, 8).astype(np.float32)
    left = rng.random(8) < 0.5
    nan_retro = retro.copy()
    nan_retro[[1, 6]] = np.nan          # failed bones and proximal-only
    return {
        "random": (retro, ns, rad, left),
        "nan lanes": (nan_retro, ns, rad, left),
        "identical 114": (np.full(8, 114.0, np.float32),
                          np.full(8, 114.0, np.float32), rad, left),
    }


@pytest.mark.parametrize("case", list(_cases()))
@pytest.mark.parametrize("n_dev", [1, 4])
def test_cohort_stats_matches_jax_and_numpy(case, n_dev):
    x = _cases()[case]
    mesh = tmesh.bone_mesh([CPU] * n_dev)
    lm = STATS(*(torch.as_tensor(a) for a in x))
    got = {k: float(v) for k, v in
           tmesh.cohort_stats(tmesh.shard_bones(lm, mesh), mesh).items()}
    ref = _jax_stats(x)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-6), k
    for name, a in zip(("retroversion", "neckshaft", "radius"), x[:3]):
        a = a.astype(np.float64)
        assert got[f"n_{name}"] == np.isfinite(a).sum()
        assert got[f"mean_{name}"] == pytest.approx(np.nanmean(a), rel=1e-6)
        assert got[f"std_{name}"] == pytest.approx(np.nanstd(a), rel=1e-5,
                                                   abs=1e-5)
    assert got["left_fraction"] == pytest.approx(x[3].mean())
    if case == "identical 114":
        assert got["std_retroversion"] == 0.0 == got["std_neckshaft"]
        assert got["mean_retroversion"] == 114.0


def test_cohort_stats_of_an_unsharded_batch(unsharded):
    """A stacked Landmarks is sharded by cohort_stats itself; the proximal
    NaN convention aside, every bone here counts."""
    mesh = tmesh.bone_mesh([CPU] * 2)
    got = tmesh.cohort_stats(unsharded, mesh)
    retro = unsharded.retroversion.double().numpy()
    assert float(got["n_retroversion"]) == 4.0
    assert float(got["mean_retroversion"]) == pytest.approx(retro.mean(),
                                                            rel=1e-6)


def test_process_cohort_on_a_mesh_equals_unsharded(paths):
    """process_cohort(device_mesh=...) gives the unsharded cohort's result
    dicts exactly; a batch of 3 rounds up to the mesh's 2 devices."""
    ref = tcohort.process_cohort(paths, config=CFG, device="cpu",
                                 batch_size=4)
    got = tcohort.process_cohort(paths, config=CFG, batch_size=3,
                                 device_mesh=tmesh.bone_mesh([CPU] * 2))
    assert len(got) == len(ref) == len(paths)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if isinstance(r[k], np.ndarray):
                assert np.array_equal(g[k], r[k]), k
            else:
                assert g[k] == r[k] or (g[k] != g[k] and r[k] != r[k]), k
