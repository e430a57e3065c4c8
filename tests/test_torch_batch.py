"""The port's batched pipeline: a bone batch runs as one program.

Four distinct bones (different seeds, left and right mixed) at
tiny_config on the CPU (the plain slice stack stands in for the kernel).
The batch must equal each bone run alone, keep every per-bone reduction
per bone (a batch of identical bones could not show a leak between
bones; a mixed one can), equal the JAX package's vmapped batch, and run
as one set of ops whatever the batch size: no loop over bones and no
host read outside the plain walk.
"""

import collections

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from shoulder_tpu.config import tiny_config as jax_tiny_config
from shoulder_tpu.io import ingest as jax_ingest
from shoulder_tpu.io import stl
from shoulder_tpu.io.testdata import synthetic_humerus
from shoulder_tpu.models import forest as jforest
from shoulder_tpu.pipeline import batch as jbatch
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.models import forest as tforest
from shoulder_tpu_torch.ops import slicing as tsl
from shoulder_tpu_torch.pipeline import batch as tbatch
from shoulder_tpu_torch.pipeline import landmarks as tlm
from shoulder_tpu_torch.utils import geometry as tgeom

SIDES = ("left", "right", "right", "left")
INT_FIELDS = ("side_is_left", "qc_slice_overflow", "qc_peak_overflow",
              "qc_open_edges", "sn_n", "anp_n", "canal_mask")
AXES = ("canal_axis", "bg_axis", "anp_axis_normal", "anp_axis_central",
        "te_axis")
METRICS = ("neckshaft", "retroversion", "radius_curvature")
CFG = tiny_config()


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    """Four distinct bones, ingested once by the JAX package (the port's
    ingest gives the same specs, tests/test_torch_native.py)."""
    out = []
    d = tmp_path_factory.mktemp("batch")
    for i, side in enumerate(SIDES):
        v, f = synthetic_humerus(side=side, n_rings=40, n_theta=32,
                                 rng_transform=np.random.default_rng(20 + i))
        path = d / f"bone{i}.stl"
        stl.write_stl(path, v, f)
        out.append(jax_ingest.load_bone(path, config=jax_tiny_config()))
    return out


@pytest.fixture(scope="module")
def rf():
    return tforest.load_params("cpu")


@pytest.fixture(scope="module")
def batch(specs, rf):
    return tbatch.compute_landmarks_batch(tbatch.stack_bones(specs, "cpu"),
                                          rf, cfg=CFG)


def _numpy(lm):
    return tlm.Landmarks(*(x.numpy() for x in lm))


@pytest.mark.parametrize("i", range(len(SIDES)))
def test_batch_equals_each_bone_alone(specs, rf, batch, i):
    """Bone i of the batch against compute_landmarks(bone i): integer,
    boolean and index fields exact, floats within 1e-4 deg / mm."""
    one = tlm.compute_landmarks(tbatch.bone_tensors(specs[i], "cpu"), rf,
                                cfg=CFG)
    for name in tlm.Landmarks._fields:
        got, want = getattr(batch, name)[i], getattr(one, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name in INT_FIELDS or not want.dtype.is_floating_point:
            assert torch.equal(got, want), name
        else:
            assert torch.equal(got.isnan(), want.isnan()), name
            assert torch.allclose(got.nan_to_num(), want.nan_to_num(),
                                  rtol=0.0, atol=1e-4), name


def test_reversed_batch_reverses_the_result(specs, rf, batch):
    rev = tbatch.compute_landmarks_batch(
        tbatch.stack_bones(specs[::-1], "cpu"), rf, cfg=CFG)
    for name in tlm.Landmarks._fields:
        assert torch.equal(getattr(rev, name).flip(0).nan_to_num(),
                           getattr(batch, name).nan_to_num()), name


def test_batched_sorted_geom_and_plain_stack_equal_per_bone(specs):
    """sorted_geom over (B, F, ...) and the plain slice stack over (B, S)
    planes, bit for bit the per-bone calls, on each bone's own planes."""
    bones = tbatch.stack_bones(specs, "cpu")
    v_obb = tgeom.transform_pts(bones.verts, bones.obb_transform)
    sg = tsl.sorted_geom(v_obb, bones.faces, bones.neighbors, bones.face_orig)
    sset = CFG.proximal
    zs = tgeom.linspace(0.9 * bones.z_max, 0.9 * bones.z_min, sset.zslice_num)
    got = tsl.slice_stack(sg, zs, sset.interp_num, sset.band,
                          CFG.slice_compact_k, chunk=40)
    for i in range(len(specs)):
        one = tsl.sorted_geom(v_obb[i], bones.faces[i], bones.neighbors[i],
                              bones.face_orig[i])
        for name, g, w in zip(tsl.SortedGeom._fields, sg, one):
            assert torch.equal(g[i], w), name
        want = tsl.slice_stack(one, zs[i], sset.interp_num, sset.band,
                               CFG.slice_compact_k)
        for name, g, w in zip(tsl.SliceStack._fields, got, want):
            assert torch.equal(g[i], w), name


def test_batched_raw_loop_equals_per_bone(specs):
    """slice_raw_banded on one plane per bone equals the one-bone call on
    each, including the loop's gathered count, area and centroid."""
    bones = tbatch.stack_bones(specs, "cpu")
    v_obb = tgeom.transform_pts(bones.verts, bones.obb_transform)
    sg = tsl.sorted_geom(v_obb, bones.faces, bones.neighbors, bones.face_orig)
    z = 0.3 * bones.z_max + 0.7 * bones.z_min
    raw, over = tsl.slice_raw_banded(sg, z, 512, CFG.max_chain, "central")
    for i in range(len(specs)):
        one = tsl.SortedGeom(*(x[i:i + 1] for x in sg))
        raw_i, over_i = tsl.slice_raw_banded(one, z[i:i + 1], 512,
                                             CFG.max_chain, "central")
        assert torch.equal(over[i], over_i[0])
        for name, g, w in zip(tsl.RawLoop._fields, raw, raw_i):
            assert torch.equal(g[i], w[0]), name


def test_batch_matches_jax_batch(specs, batch):
    """The JAX package's compute_landmarks_batch (vmap on the CPU, its own
    RANSAC draw, which the port's is) on the same four bones, at
    tests/test_torch_pipeline.py's tolerances."""
    ref = jax.tree.map(np.asarray, jbatch.compute_landmarks_batch(
        jbatch.stack_bones(specs), jforest.load_params(),
        cfg=jax_tiny_config()))
    got = _numpy(batch)
    for name in ("side_is_left", "qc_slice_overflow", "qc_peak_overflow",
                 "qc_open_edges", "sn_n", "anp_n"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name
    for name in METRICS:
        assert np.nanmax(np.abs(getattr(got, name) - getattr(ref, name))) \
            < 0.75, name
    for name in AXES:
        assert np.allclose(getattr(got, name), getattr(ref, name),
                           atol=1e-2), name


class _OpCount(TorchDispatchMode):
    """Counts every aten op dispatched outside slicing.slice_stack (one
    kernel launch per stack on the card)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.inside_stack = False
        self.stacks = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.inside_stack:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _count(bones, rf, monkeypatch):
    mode = _OpCount()
    stack = tsl.slice_stack

    def counted(*args, **kwargs):
        mode.stacks += 1
        mode.inside_stack = True
        try:
            return stack(*args, **kwargs)
        finally:
            mode.inside_stack = False

    monkeypatch.setattr(tsl, "slice_stack", counted)
    with mode:
        tbatch.compute_landmarks_batch(bones, rf, cfg=CFG)
    monkeypatch.setattr(tsl, "slice_stack", stack)
    return mode


def test_no_loop_over_bones_and_no_host_reads(specs, rf, monkeypatch):
    """Four copies of a bone dispatch exactly the ops of that bone alone,
    the three stacks are three slice_stack calls per batch, and no op
    reads a value back to the host (aten._local_scalar_dense) outside the
    plain walk inside slice_stack.  A first run fills the per-process
    constants (the RANSAC draw, the Savitzky-Golay edge weights)."""
    tbatch.compute_landmarks_batch(tbatch.stack_bones(specs[:1], "cpu"), rf,
                                   cfg=CFG)
    one = _count(tbatch.stack_bones(specs[:1], "cpu"), rf, monkeypatch)
    four = _count(tbatch.stack_bones(specs[:1] * 4, "cpu"), rf, monkeypatch)
    assert one.stacks == four.stacks == 3
    assert sum(one.ops.values()) > 1000
    assert four.ops == one.ops
    assert one.ops["aten._local_scalar_dense.default"] == 0
