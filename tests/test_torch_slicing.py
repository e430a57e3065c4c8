"""The port's slicing (walk path) vs shoulder_tpu's slicing on the CPU.

Both sides get the same OBB-frame vertices (computed once with the JAX
package), so crossing decisions see identical inputs: integer outputs
(crossed sets, successors, face ids, flags) must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoulder_tpu.config import tiny_config
from shoulder_tpu.ops import slicing as jsl
from shoulder_tpu.utils import geometry as jgeom
from shoulder_tpu_torch.ops import slicing as tsl

CFG = tiny_config()


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


def _jax_compact(jsg, zs, band, k):
    los, starts, win_over = jsl._window_starts(jsg, jnp.asarray(zs), band)

    def one(z, lo, st):
        zmm = jax.lax.dynamic_slice_in_dim(jsg.z_mm, lo, band, axis=0)
        return jsl._compact_slice(jsg, zmm, lo, st, z, k)

    out = jax.vmap(one)(jnp.asarray(zs), los, starts)
    return np.asarray(los), np.asarray(win_over), [np.asarray(x) for x in out]


def _torch_compact(tsg, zs, band, k):
    zs = torch.as_tensor(zs)
    los, _starts, win_over = tsl._window_starts(tsg, zs, band)
    zmm = tsg.z_mm[los[:, None] + torch.arange(band)]
    out = tsl._compact_slice(tsg, zmm, los, zs, k)
    return los.numpy(), win_over.numpy(), [x.numpy() for x in out]


def _assert_compact_equal(jax_out, torch_out):
    j_lo, j_win, (jc, js, je, jsucc, jorig, jover, jopen) = jax_out
    t_lo, t_win, (tc, ts, te, tsucc, torig, tover, topen) = torch_out
    assert np.array_equal(t_lo, j_lo)
    assert np.array_equal(t_win, j_win)
    assert np.array_equal(tc, jc)
    assert np.array_equal(tsucc, jsucc)
    assert np.array_equal(torig[jc], jorig[jc])
    assert np.array_equal(tover, jover)
    assert np.array_equal(topen, jopen)
    # the segment math is elementwise on identical inputs; 1e-5 covers
    # float contraction differences between XLA and eager torch
    assert np.allclose(ts[jc], js[jc], atol=1e-5)
    assert np.allclose(te[jc], je[jc], atol=1e-5)


def test_compact_slice_matches_jax(geoms):
    v_obb, jsg, tsg, _ = geoms
    zlo, zhi = v_obb[:, 2].min(), v_obb[:, 2].max()
    zs = np.linspace(zhi - 1.0, zlo + 1.0, 40).astype(np.float32)
    band, k = 512, 384
    jout = _jax_compact(jsg, zs, band, k)
    assert jout[2][0].sum() > 40 * 10      # the planes do cross the bone
    _assert_compact_equal(jout, _torch_compact(tsg, zs, band, k))


def test_compact_slice_grazing_plane_matches_jax(geoms):
    """Planes through mesh vertices (d == 0 for a vertex): the
    combinatorial orientation and the successor injectivity rule must
    resolve them exactly as the JAX package does."""
    v_obb, jsg, tsg, spec = geoms
    real = v_obb[: spec.n_verts]
    order = np.argsort(real[:, 2])
    zs = real[order[len(order) // 5:: len(order) // 9][:8], 2]
    band, k = 512, 384
    jout = _jax_compact(jsg, zs, band, k)
    tout = _torch_compact(tsg, zs, band, k)
    _assert_compact_equal(jout, tout)
    crossed, succ = tout[2][0], tout[2][3]
    for r in range(len(zs)):
        slots = np.flatnonzero(crossed[r])
        linked = succ[r, slots][succ[r, slots] != slots]
        assert len(set(linked.tolist())) == len(linked), f"plane {r}"


@pytest.mark.parametrize("stack", ["full", "proximal", "distal"])
def test_slice_stack_walk_matches_jax(geoms, stack):
    """Port (walk path, plain walk on the CPU) vs the JAX package's CPU
    default (pointer doubling), at tiny_config's stack shapes."""
    v_obb, jsg, tsg, spec = geoms
    sset = getattr(CFG, stack)
    zlo, zhi = 0.99 * v_obb[:, 2].min(), 0.99 * v_obb[:, 2].max()
    zs = np.linspace(zhi, zlo, sset.zslice_num).astype(np.float32)
    s = jsl.slice_stack(
        jnp.asarray(v_obb), jnp.asarray(spec.faces), jnp.asarray(spec.neighbors),
        jnp.asarray(zs), sset.interp_num, CFG.max_chain, 150, sset.band,
        sg=jsg, compact_k=CFG.slice_compact_k,
    )
    j = jax.tree.map(np.asarray, s)
    t = tsl.slice_stack(tsg, torch.as_tensor(zs), sset.interp_num,
                        sset.band, CFG.slice_compact_k, chunk=16)
    t = tsl.SliceStack(*(x.numpy() for x in t))
    assert np.array_equal(t.overflow, j.overflow)
    assert np.array_equal(t.open_edges, j.open_edges)
    ok = ~j.overflow
    assert ok.sum() >= 0.8 * len(zs)
    # tolerances of tests/test_slice_kernel.py::test_walk_path_matches_doubling:
    # the two paths group the same float sums differently
    assert np.allclose(t.areas[ok], j.areas[ok], atol=0.01)
    assert np.allclose(t.total_areas[ok], j.total_areas[ok], atol=0.01)
    assert np.allclose(t.centroids[ok], j.centroids[ok], atol=1e-3)
    assert np.allclose(t.contours[ok], j.contours[ok], atol=1e-3)


def _raw_one(sg, z, *args, **kw):
    """The port's slice_raw_banded on one bone: a batch of one."""
    raw, over = tsl.slice_raw_banded(tsl.SortedGeom(*(x[None] for x in sg)),
                                     torch.as_tensor(z)[None], *args, **kw)
    return tsl.RawLoop(*(x[0] for x in raw)), over[0]


@pytest.mark.parametrize("select", ["central", "largest"])
def test_slice_raw_banded_matches_jax(geoms, select):
    v_obb, jsg, tsg, _ = geoms
    zlo, zhi = v_obb[:, 2].min(), v_obb[:, 2].max()
    for rel in (0.3, 0.55, 0.8):
        z = np.float32(zlo + rel * (zhi - zlo))
        jraw, jover = jsl.slice_raw_banded(jsg, z, 512, CFG.max_chain, select)
        traw, tover = _raw_one(tsg, z, 512, CFG.max_chain, select)
        n = int(jraw.n)
        assert int(traw.n) == n and n > 10
        assert bool(tover) == bool(jover)
        # points: the same segment arithmetic (float contraction may
        # differ); area and centroid: scatter-add sums in another order
        assert np.allclose(traw.points[:n].numpy(), np.asarray(jraw.points)[:n],
                           atol=1e-4)
        assert float(traw.area) == pytest.approx(float(jraw.area), abs=0.01)
        assert np.allclose(traw.centroid.numpy(), np.asarray(jraw.centroid),
                           atol=1e-3)


@pytest.mark.parametrize("select", ["central", "largest"])
def test_slice_raw_banded_overflow_matches_jax(geoms, select):
    """k below the plane's crossing count: the compaction drops faces, the
    chains break, and ranks run past the loop's count.  The port places
    those points where the JAX package's scatter does (negative positions
    wrap once from the end) instead of failing on them."""
    v_obb, jsg, tsg, _ = geoms
    zlo, zhi = v_obb[:, 2].min(), v_obb[:, 2].max()
    wrapped = 0
    for rel in (0.3, 0.55, 0.8):
        z = np.float32(zlo + rel * (zhi - zlo))
        jraw, jover = jsl.slice_raw_banded(jsg, z, 512, CFG.max_chain, select,
                                           k=24)
        traw, tover = _raw_one(tsg, z, 512, CFG.max_chain, select, k=24)
        assert bool(jover) and bool(tover)
        assert int(traw.n) == int(jraw.n)
        jpts = np.asarray(jraw.points)
        assert np.allclose(traw.points.numpy(), jpts, atol=1e-4)
        wrapped += int(np.abs(jpts[int(jraw.n):]).sum() > 0)
    assert wrapped > 0      # some chain did land past the count


def test_compact_points_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    mask = rng.random(500) < 0.3
    jp, jn = jsl.compact_points(jnp.asarray(pts), jnp.asarray(mask), 256)
    tp, tn = tsl.compact_points(torch.as_tensor(pts), torch.as_tensor(mask), 256)
    assert int(tn) == int(jn)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
