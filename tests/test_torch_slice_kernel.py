"""The slice-stack stage behind the fused kernel (csrc/slice_stack.cu).

On the CPU, `slice_stack` runs the plain composition that is the kernel's
plain version; here it is held against the JAX package's walk branch
(the Pallas walk in interpret mode) on the planes the kernel must get
right: empty planes above and below the bone, planes through vertices
(grazing), and a k small enough to overflow.  The build key, the
wrapper's argument checks and the port's own forest file are checked
here too.  The kernel itself runs only on a card (`cuda` marker).
"""

import re
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoulder_tpu.config import tiny_config
from shoulder_tpu.ops import slicing as jsl
from shoulder_tpu.utils import geometry as jgeom
from shoulder_tpu_torch.models import forest as tforest
from shoulder_tpu_torch.ops import kernels
from shoulder_tpu_torch.ops import slicing as tsl
from shoulder_tpu_torch.utils import trace

CFG = tiny_config()
STACKS = ["full", "proximal", "distal"]


@pytest.fixture(scope="module")
def geoms(tiny_spec):
    s = tiny_spec
    v_obb = np.array(jgeom.transform_pts(
        s.vertices, s.obb_transform.astype(np.float32)))
    jsg = jsl.sorted_geom(jnp.asarray(v_obb), jnp.asarray(s.faces),
                          jnp.asarray(s.neighbors),
                          face_orig=jnp.asarray(s.face_orig))
    tsg = tsl.sorted_geom(torch.as_tensor(v_obb), torch.as_tensor(s.faces),
                          torch.as_tensor(s.neighbors),
                          torch.as_tensor(s.face_orig))
    return v_obb, jsg, tsg, s


def _edge_planes(v_obb, n_verts):
    """Empty planes above and below the bone, planes at exact vertex
    heights, and ordinary planes between."""
    z = v_obb[:n_verts, 2]
    zlo, zhi = float(z.min()), float(z.max())
    zv = np.sort(z)[len(z) // 9:: len(z) // 7][:6]
    return np.concatenate([
        [zhi + 5.0, zhi + 1e-3, zlo - 1e-3, zlo - 5.0], zv,
        np.linspace(0.9 * zhi, 0.9 * zlo, 4),
    ]).astype(np.float32)


def _stacks(geoms, stack, zs, k):
    v_obb, jsg, tsg, spec = geoms
    sset = getattr(CFG, stack)
    j = jsl.slice_stack(
        jnp.asarray(v_obb), jnp.asarray(spec.faces),
        jnp.asarray(spec.neighbors), jnp.asarray(zs), sset.interp_num,
        CFG.max_chain, 150, sset.band, use_walk=True, sg=jsg, compact_k=k,
    )
    t = tsl.slice_stack(tsg, torch.as_tensor(zs), sset.interp_num,
                        sset.band, k)
    return (tsl.SliceStack(*(np.asarray(x) for x in j)),
            tsl.SliceStack(*(x.numpy() for x in t)))


def _assert_close(j, t):
    assert np.array_equal(t.overflow, j.overflow)
    assert np.array_equal(t.open_edges, j.open_edges)
    ok = ~j.overflow
    # tolerances of tests/test_slice_kernel.py::test_walk_path_matches_doubling
    assert np.allclose(t.areas[ok], j.areas[ok], atol=0.01)
    assert np.allclose(t.total_areas[ok], j.total_areas[ok], atol=0.01)
    assert np.allclose(t.centroids[ok], j.centroids[ok], atol=1e-3)
    assert np.allclose(t.contours[ok], j.contours[ok], atol=1e-3)


@pytest.mark.parametrize("stack", STACKS)
def test_plain_slice_stack_matches_jax_walk_on_edge_planes(geoms, stack):
    zs = _edge_planes(geoms[0], geoms[3].n_verts)
    j, t = _stacks(geoms, stack, zs, CFG.slice_compact_k)
    _assert_close(j, t)
    # the empty planes give empty slices; the vertex planes real loops
    assert (t.areas[[0, 1, 2, 3]] == 0).all()
    assert (t.contours[[0, 3]] == 0).all()
    assert (t.areas[4:] > 1.0).sum() >= 6


@pytest.mark.parametrize("stack", STACKS)
def test_plain_slice_stack_matches_jax_walk_when_k_overflows(geoms, stack):
    v_obb = geoms[0]
    zs = np.linspace(0.9 * v_obb[:, 2].max(), 0.9 * v_obb[:, 2].min(),
                     8).astype(np.float32)
    j, t = _stacks(geoms, stack, zs, 24)
    assert t.overflow.sum() >= 4      # k = 24 is too small for most planes
    _assert_close(j, t)


@pytest.mark.parametrize("chunk", [1, 7, 150])
def test_plain_slice_stack_independent_of_chunk(geoms, chunk):
    v_obb, _jsg, tsg, _ = geoms
    sset = CFG.proximal
    zs = torch.linspace(0.99 * float(v_obb[:, 2].max()),
                        0.99 * float(v_obb[:, 2].min()), sset.zslice_num)
    want = tsl.slice_stack(tsg, zs, sset.interp_num, sset.band,
                           CFG.slice_compact_k, chunk=sset.zslice_num)
    got = tsl.slice_stack(tsg, zs, sset.interp_num, sset.band,
                          CFG.slice_compact_k, chunk=chunk)
    for name, g, w in zip(tsl.SliceStack._fields, got, want):
        assert torch.equal(g, w), name


def _fake_nvcc(calls):
    """A stand-in for subprocess.run that records each nvcc command and
    writes its -o target, as a successful nvcc would."""
    def run(cmd, **kwargs):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as fh:
            fh.write(b"built")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info\n")
    return run


def test_build_key_tracks_every_source_and_header(tmp_path, monkeypatch):
    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    (src / "a.cu").write_text('#include "w.cuh"\n')
    (src / "b.cu").write_text('#include "w.cuh"\n')
    (src / "w.cuh").write_text("// walk\n")
    calls = []
    monkeypatch.setattr(kernels.subprocess, "run", _fake_nvcc(calls))

    first = kernels.build(src, out)
    compiles = [c for c in calls if "-c" in c]
    assert len(compiles) == 2 and len(calls) == 3     # one nvcc per source
    for c in compiles:
        assert "-fmad=false" in c and "arch=compute_90a,code=sm_90a" in c
    assert first.exists() and first.with_suffix(".log").exists()
    assert kernels.build(src, out) == first and len(calls) == 3

    seen = {first}
    for edit in ("w.cuh", "a.cu"):
        (src / edit).write_text((src / edit).read_text() + "// edited\n")
        path = kernels.build(src, out)
        assert path not in seen
        seen.add(path)
    (src / "extra.cuh").write_text("// new header\n")
    assert kernels.build(src, out) not in seen
    assert len(calls) == 12


def test_failed_build_raises_and_leaves_no_library(tmp_path, monkeypatch):
    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    (src / "a.cu").write_text("bad\n")
    monkeypatch.setattr(
        kernels.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, "", "error"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build(src, out)
    assert not list(out.glob("*.so"))


def _bad_args(tsg, zs):
    n_faces = tsg.z_key.shape[0]
    fvt_strided = tsg.fvt.t().contiguous().t()
    return {
        "dtype": (tsg._replace(fvt=tsg.fvt.double()), zs, 512, 384,
                  TypeError),
        "zs dtype": (tsg, zs.double(), 512, 384, TypeError),
        "non-contiguous": (tsg._replace(fvt=fvt_strided), zs, 512, 384,
                           ValueError),
        "k above limit": (tsg, zs, n_faces, tsl.KERNEL_MAX_K + 1,
                          ValueError),
        "k above band": (tsg, zs, 256, 384, ValueError),
        "shape": (tsg._replace(ids=tsg.ids[:, :3].contiguous()), zs, 512,
                  384, ValueError),
    }


@pytest.mark.parametrize("case", ["dtype", "zs dtype", "non-contiguous",
                                  "k above limit", "k above band", "shape"])
def test_kernel_wrapper_checks_before_any_launch(geoms, monkeypatch, case):
    tsg = geoms[2]
    assert tsg.z_key.shape[0] > tsl.KERNEL_MAX_K   # room for the k case
    zs = torch.linspace(1.0, -1.0, 5)

    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(kernels, "library", no_library)
    sg, zs_, band, k, err = _bad_args(tsg, zs)[case]
    before = trace.counter("launches.slice_stack")
    with pytest.raises(err):
        tsl.slice_stack_kernel(sg, zs_, 64, band, k)
    assert trace.counter("launches.slice_stack") == before


def test_cpu_tensors_take_the_plain_version(geoms, monkeypatch):
    """On CPU tensors slice_stack never reaches the kernel library, and
    the kernel wrapper refuses them rather than falling back."""
    tsg = geoms[2]

    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(kernels, "library", no_library)
    zs = torch.linspace(1.0, -1.0, 5)
    before = trace.counter("launches.slice_stack")
    st = tsl.slice_stack(tsg, zs, 64, 512, 384)
    assert st.contours.shape == (5, 64, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tsl.slice_stack_kernel(tsg, zs, 64, 512, 384)
    assert trace.counter("launches.slice_stack") == before


def test_stage_times_converts_block_clocks():
    """Stamps of two blocks at 2 cycles per ns: each stage's microseconds
    and the clock come back."""
    n = len(tsl.STAGES)
    cycles = torch.tensor([[2000 * i for i in range(n + 1)],
                           [4000 * i for i in range(n + 1)]])
    ns = torch.tensor([[0, 1000 * n], [500, 500 + 2000 * n]])
    us, ghz = tsl.stage_times(torch.cat([cycles, ns], dim=1))
    assert ghz == pytest.approx(2.0)
    assert us.shape == (2, n)
    assert torch.allclose(us[0], torch.full((n,), 1.0, dtype=us.dtype))
    assert torch.allclose(us[1], torch.full((n,), 2.0, dtype=us.dtype))


def test_timed_launch_checks_its_stamps(geoms):
    tsg = geoms[2]
    zs = torch.linspace(1.0, -1.0, 5)
    with pytest.raises(ValueError, match="stamps"):
        tsl.slice_stack_kernel(tsg, zs, 64, 512, 384,
                               stamps=torch.zeros(5, 11, dtype=torch.int64))


def test_timed_launch_checks_its_walk(geoms):
    tsg = geoms[2]
    zs = torch.linspace(1.0, -1.0, 5)
    i32 = dict(dtype=torch.int32)
    for walk in ((torch.zeros(5, 383, **i32), torch.zeros(5, **i32)),
                 (torch.zeros(5, 384, **i32), torch.zeros(5, dtype=torch.int64)),
                 (torch.zeros(384, 5, **i32).t(), torch.zeros(5, **i32))):
        with pytest.raises(ValueError, match="walk"):
            tsl.slice_stack_kernel(tsg, zs, 64, 512, 384, walk=walk)


def _kernel_constant(name):
    """An int constexpr of csrc/slice_stack.cu, so the plain statement of
    its search below follows the kernel's own block size."""
    src = (kernels.CSRC / "slice_stack.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def window_count(z_key, zs):
    """The slice-stack kernel's window search (stage 1) in plain PyTorch:
    the insertion point of each plane of zs (..., S) in its bone's sorted
    keys z_key (..., F), side left, found as the count of keys below it.
    While more than `keys` keys per thread are left, each of the block's
    `threads` threads tests one key at a stride and the count of keys
    below the plane narrows the range to one stride; then the threads
    count what is left."""
    threads = _kernel_constant("kThreads")
    keys = _kernel_constant("kSearchKeys")
    n_faces = z_key.shape[-1]

    def below(idx, ok):  # keys below the plane among idx (..., S, m) if ok
        at = torch.where(ok, idx, 0).reshape(zs.shape[:-1] + (-1,))
        got = z_key.gather(-1, at).reshape(idx.shape)
        return ((got < zs[..., None]) & ok).sum(dim=-1)

    a0 = torch.zeros(zs.shape, dtype=torch.int64)
    span = torch.full(zs.shape, n_faces, dtype=torch.int64)
    lanes = torch.arange(1, threads + 1)
    while bool((live := span > threads * keys).any()):
        stride = (span + threads - 1) // threads
        idx = a0[..., None] + lanes * stride[..., None] - 1
        ok = live[..., None] & (idx < (a0 + span)[..., None])
        a1 = a0 + below(idx, ok) * stride
        span = torch.where(live, torch.minimum(stride - 1, a0 + span - a1),
                           span)
        a0 = torch.where(live, a1, a0)
    idx = a0[..., None] + torch.arange(threads * keys)
    return a0 + below(idx, idx < (a0 + span)[..., None])


def _search_cases(tsg):
    """(z_key (2, F), cummax_z_max (2, F), zs (2, S)) at growing F: the
    tiny bone's keys, then the same keys on 0.5 mm steps (ties); the
    second bone of each pair is shorter, its tail +inf as in a padded
    batch; planes above, below, at exact key values and between."""
    keys, cmax = tsg.z_key, tsg.cummax_z_max
    n = int(torch.isfinite(keys).sum())
    keys, cmax = keys[:n], cmax[:n]
    tied = torch.round(keys * 2.0) / 2.0
    rng = np.random.default_rng(5)
    for base in (keys, tied):
        lo, hi = float(base[0]), float(base[-1])
        zs = torch.cat([torch.tensor([hi + 5.0, hi, lo, lo - 1.0]),
                        base[rng.integers(0, n, 12)],
                        torch.as_tensor(rng.uniform(lo, hi, 8),
                                        dtype=torch.float32)])
        for n_faces in (1500, n, 40960, 300000, 600000):
            pad = torch.full((max(n_faces - n, 0),), float("inf"))
            k1 = torch.cat([base, pad])[:n_faces]
            k2 = k1.clone()
            k2[n_faces * 3 // 5:] = float("inf")
            c1 = torch.cat([cmax, cmax[-1:].expand(pad.shape[0])])[:n_faces]
            yield (torch.stack([k1, k2]), torch.stack([c1, c1]),
                   torch.stack([zs, zs.flip(0)]).contiguous())


def test_window_count_is_searchsorted_side_left(geoms):
    """The kernel's window search (`window_count`: strided probes counted
    by the block, then a direct count) gives searchsorted's
    insertion point, and so `_window_starts`'s and the JAX package's
    windows and overflow flags, on edge planes, ties, +inf-padded bones and
    face counts that take zero, one and two probe levels."""
    band = 512
    for keys, cmax, zs in _search_cases(geoms[2]):
        count = window_count(keys, zs)
        assert torch.equal(count, torch.searchsorted(keys, zs, side="left"))
        sg = types.SimpleNamespace(z_key=keys, cummax_z_max=cmax)
        lo, starts, over = tsl._window_starts(sg, zs, band)
        assert torch.equal(count, starts)
        for b in range(2):
            jsg = types.SimpleNamespace(z_key=jnp.asarray(keys[b].numpy()),
                                        cummax_z_max=jnp.asarray(
                                            cmax[b].numpy()))
            j_lo, j_starts, j_over = jsl._window_starts(
                jsg, jnp.asarray(zs[b].numpy()), band)
            assert np.array_equal(count[b].numpy(), np.asarray(j_starts))
            assert np.array_equal(lo[b].numpy(), np.asarray(j_lo))
            assert np.array_equal(over[b].numpy(), np.asarray(j_over))


def test_port_forest_npz_equals_the_jax_package_file():
    jax_npz = (tforest.DEFAULT_NPZ.parents[3] / "shoulder_tpu" / "models"
               / "params" / "rfc_bg3.npz")
    assert tforest.DEFAULT_NPZ.parent.parent.parent.name == "shoulder_tpu_torch"
    with np.load(tforest.DEFAULT_NPZ) as mine, np.load(jax_npz) as ref:
        assert sorted(mine.files) == sorted(ref.files)
        for name in ref.files:
            assert mine[name].dtype == ref[name].dtype, name
            assert np.array_equal(mine[name], ref[name]), name
