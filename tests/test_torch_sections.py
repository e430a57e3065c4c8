"""The port's full-set and arbitrary-plane sections, its device z-sort,
`fit_circle` and `first_hit` against the JAX package's, on the CPU.

Twins of tests/test_slice_kernel.py:70-135 (raw loops against the numpy
oracle, the banded loop against the full-set one, central and largest
selection) and of tests/test_models_and_geom_ops.py's ray and circle
cases, each also held against the same JAX function on the same input.

Tolerances, stated once: integer outputs (crossed sets, counts, sort
orders, neighbour ids, hit flags) exactly; the device sort's keys and
geometry bit for bit; loop points within 2e-3 mm of the oracle (its
test's bound) and 1e-4 mm of JAX's; loop areas within 1e-5 relative
(sums in another order); section points within 1e-4 mm; circle fits
within 1e-4 relative of JAX's lstsq; ray hits within 1e-4 mm.
"""

import numpy as np
import pytest
import torch

from shoulder_tpu.host import slicing_np
from shoulder_tpu.io import stl
from shoulder_tpu.ops import rays as jrays
from shoulder_tpu.ops import slicing as jsl
from shoulder_tpu.utils import fits as jfits
from shoulder_tpu_torch.ops import rays as trays
from shoulder_tpu_torch.ops import slicing as tsl
from shoulder_tpu_torch.utils import fits as tfits


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bone(synthetic_bone):
    verts, faces = synthetic_bone
    nb, wt = stl.edge_face_adjacency(faces)
    assert wt
    return verts, verts.astype(np.float32), faces.astype(np.int32), \
        nb.astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _raw(v32, f32, nb, z, select="largest", **kw):
    """The port's slice_raw of one bone: a batch of one, indexed."""
    tv, tf, tn = _t(v32, f32, nb)
    loop = tsl.slice_raw(tv[None], tf[None], tn[None],
                         torch.tensor([z], dtype=torch.float32),
                         select=select, **kw)
    return tsl.RawLoop(*(x[0] for x in loop))


def _assert_raw_close(got, want):
    n = int(want.n)
    assert int(got.n) == n
    assert np.allclose(got.points[:n].numpy(), np.asarray(want.points[:n]),
                       atol=1e-4)
    assert float(got.area) == pytest.approx(float(want.area), rel=1e-5)
    assert np.allclose(got.centroid.numpy(), np.asarray(want.centroid),
                       atol=1e-3)


@pytest.mark.parametrize("rel_z", [0.15, 0.5, 0.9])
def test_raw_loop_matches_oracle(bone, rel_z):
    verts, v32, f32, nb = bone
    zlo, zhi = verts[:, 2].min(), verts[:, 2].max()
    z = float(np.float32(zlo + rel_z * (zhi - zlo)))
    raw = _raw(v32, f32, nb, z)
    loop = slicing_np.largest_loop(slicing_np.cross_section(verts, f32, nb,
                                                            z))
    n = int(raw.n)
    assert n == loop["points"].shape[0]
    assert np.allclose(raw.points[:n].numpy(), loop["points"], atol=2e-3)
    _assert_raw_close(raw, jsl.slice_raw(v32, f32, nb, np.float32(z)))


def test_raw_banded_matches_full_set(bone):
    """The banded loop (ingest-presorted faces, loop start at the smallest
    original id) equals the full-set one, and a k above the band is
    clamped to it (an unclamped k would repeat window face 0)."""
    verts, v32, f32, nb = bone
    z = float(np.float32(np.mean(verts[:, 2])))
    full = _raw(v32, f32, nb, z)
    sg = tsl.sorted_geom(*_t(v32, f32, nb))
    sg = tsl.SortedGeom(*(x[None] for x in sg))
    zt = torch.tensor([z], dtype=torch.float32)
    raw, overflow = tsl.slice_raw_banded(sg, zt, band=2048, k=512)
    assert not bool(overflow[0])
    n = int(full.n)
    assert int(raw.n[0]) == n
    assert np.allclose(raw.points[0, :n].numpy(), full.points[:n].numpy(),
                       atol=2e-3)
    clamped = tsl.slice_raw_banded(sg, zt, band=256, k=512)
    for a, b in zip(clamped, tsl.slice_raw_banded(sg, zt, band=256, k=256)):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def _boxes():
    """Two disjoint boxes crossing z = 0: a small one near the axis and a
    big one far from it."""
    def box(extents, center):
        e = np.asarray(extents) / 2.0
        corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)]) * e + np.asarray(center)
        quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                 (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
        return corners, np.array([f for a, b, c, d in quads
                                  for f in ([a, b, c], [a, c, d])])

    v1, f1 = box([2, 2, 2], [0.5, 0, 0])
    v2, f2 = box([8, 8, 2], [30.0, 0, 0])
    faces = np.vstack([f1, f2 + 8])
    nb, _ = stl.edge_face_adjacency(faces)
    return (np.vstack([v1, v2]).astype(np.float32), faces.astype(np.int32),
            nb.astype(np.int32))


@pytest.mark.parametrize("select", ["central", "largest"])
def test_raw_selection(select):
    verts, faces, nb = _boxes()
    raw = _raw(verts, faces, nb, 0.0, select=select)
    pts = raw.points[:int(raw.n)].numpy()
    if select == "central":
        assert np.all(np.abs(pts[:, 0]) < 3.0)   # the near-axis box
    else:
        assert np.all(pts[:, 0] > 20.0)          # the big box
    want = jsl.slice_raw(verts, faces, nb, np.float32(0.0), select=select)
    assert int(raw.n) == int(want.n)
    assert np.array_equal(raw.points.numpy(), np.asarray(want.points))


def test_raw_batch_equals_each_bone(bone, tiny_spec):
    """A batch of two meshes (the smaller padded with degenerate faces)
    gives each bone its own loop, bit for bit."""
    _, v32, f32, nb = bone
    s = tiny_spec
    pad = f32.shape[0] - s.faces.shape[0]
    v2 = np.zeros_like(v32)
    v2[:s.vertices.shape[0]] = s.vertices
    f2 = np.vstack([s.faces, np.zeros((pad, 3), np.int32)])
    n2 = np.vstack([s.neighbors, np.full((pad, 3), -1, np.int32)])
    zs = [float(np.float32(np.median(v32[:, 2]))),
          float(np.float32(np.median(s.vertices[:, 2])))]
    tv, tf, tn = _t(np.stack([v32, v2]), np.stack([f32, f2]),
                    np.stack([nb, n2]))
    both = tsl.slice_raw(tv, tf, tn, torch.tensor(zs), select="central")
    for i in range(2):
        one = tsl.slice_raw(tv[i:i + 1], tf[i:i + 1], tn[i:i + 1],
                            torch.tensor(zs[i:i + 1]), select="central")
        for a, b in zip(both, one):
            assert torch.equal(a[i], b[0])


def test_raw_open_chain_drops_and_wraps_as_jax(bone):
    """Tear the mesh at the plane: the chain that dead-ends is ranked over
    the whole face set, and its points wrap and drop in the order scatter
    as JAX's scatter puts them (ROADMAP fault 3a)."""
    verts, v32, f32, nb = bone
    z = float(np.float32(np.mean(verts[:, 2])))
    geom = jsl.face_geom(v32, f32, nb)
    crossed = np.asarray(jsl._crossing_topology(geom, np.float32(z))[0])
    torn = nb.copy()
    cut = np.flatnonzero(crossed)[::40]
    torn[cut] = -1
    for max_chain in (2048, 64):
        want = jsl.slice_raw(v32, f32, torn, np.float32(z),
                             max_chain=max_chain)
        got = _raw(v32, f32, torn, z, max_chain=max_chain)
        assert int(got.n) == int(want.n)
        assert np.allclose(got.points.numpy(), np.asarray(want.points),
                           atol=1e-4)


def test_crossing_topology_matches_jax(bone):
    verts, v32, f32, nb = bone
    z = np.float32(np.median(verts[:, 2]))
    # a plane through a vertex: the grazing case of the injectivity rule
    z_vertex = np.float32(verts[f32[1234, 0], 2])
    for zz in (z, z_vertex):
        want = jsl._crossing_segments(jsl.face_geom(v32, f32, nb), zz)
        got = tsl._crossing_segments(tsl.face_geom(*_t(v32, f32, nb)),
                                     torch.tensor(zz))
        for name, g, w in zip(("crossed", "start", "end", "succ", "open"),
                              got, want):
            if name in ("start", "end"):
                assert np.allclose(g.numpy(), np.asarray(w), atol=1e-4), name
            else:
                assert np.array_equal(g.numpy(), np.asarray(w)), name


def _tied_mesh(bone, n_pad=257):
    """The bone with its heights rounded to whole millimetres (thousands
    of faces with equal z_min) and n_pad degenerate padding faces."""
    _, v32, f32, nb = bone
    v = v32.copy()
    v[:, 2] = np.round(v[:, 2])
    faces = np.vstack([f32, np.zeros((n_pad, 3), np.int32)])
    nbr = np.vstack([nb, np.full((n_pad, 3), -1, np.int32)])
    return v, faces, nbr


def test_sorted_geom_device_sort_matches_jax(bone):
    v, faces, nbr = _tied_mesh(bone)
    z_min = v[faces][:, :, 2].min(1)
    assert len(np.unique(z_min)) < len(z_min) // 10   # ties everywhere
    want = jsl.sorted_geom(v, faces, nbr)
    got = tsl.sorted_geom(*_t(v, faces, nbr))
    assert np.array_equal(got.ids[:, 0].numpy(), np.asarray(want.orig_id))
    assert np.array_equal(got.ids[:, 1:].numpy(), np.asarray(want.neighbors))
    assert np.array_equal(got.fvt.numpy(), np.asarray(want.fvt)[:, :9])
    for name in ("z_key", "z_mm", "cummax_z_max"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    # the padding sorts to the tail, in face-id order
    assert np.array_equal(got.ids[-257:, 0].numpy(),
                          np.arange(faces.shape[0] - 257, faces.shape[0]))


def test_sorted_geom_device_sort_batch_equals_each_bone(bone):
    """Sort ties under batching: each bone of a batch sorts as it does
    alone (a second bone, shifted, has ties at other heights)."""
    v, faces, nbr = _tied_mesh(bone)
    v2 = v + np.float32([0.0, 0.0, 0.5])
    batch = tsl.sorted_geom(*_t(np.stack([v, v2]), np.stack([faces, faces]),
                                np.stack([nbr, nbr])))
    for i, vi in enumerate((v, v2)):
        one = tsl.sorted_geom(*_t(vi, faces, nbr))
        for a, b in zip(batch, one):
            assert torch.equal(a[i], b)


def test_plane_section_points_matches_jax(bone):
    verts, v32, f32, _ = bone
    origin = verts.mean(0).astype(np.float32)
    for normal in ([0.3, -0.2, 0.9], [1.0, 0.0, 0.0]):
        normal = np.float32(normal)
        want_p, want_c = jsl.plane_section_points(v32, f32, origin, normal)
        got_p, got_c = tsl.plane_section_points(*_t(v32, f32, origin, normal))
        want_c = np.asarray(want_c)
        assert want_c.sum() > 100
        assert np.array_equal(got_c.numpy(), want_c)
        assert np.allclose(got_p.numpy()[want_c], np.asarray(want_p)[want_c],
                           atol=1e-4)


def test_fit_circle_matches_jax():
    rng = np.random.default_rng(2)
    t = rng.uniform(0, 2 * np.pi, 100)
    exact = np.stack([3 + 7 * np.cos(t), -1 + 7 * np.sin(t)], 1)
    cx, cy, rad, res = tfits.fit_circle(torch.tensor(exact, dtype=torch.float32))
    assert float(rad) == pytest.approx(7.0, abs=1e-3)
    assert float(res) == pytest.approx(0.0, abs=1e-3)
    noisy = (exact + rng.normal(0, 0.1, exact.shape)).astype(np.float32)
    w = (rng.random(100) > 0.3).astype(np.float32)
    for weights in (None, w):
        want = jfits.fit_circle(noisy, weights)
        got = tfits.fit_circle(torch.from_numpy(noisy),
                               None if weights is None
                               else torch.from_numpy(weights))
        for g, j in zip(got, want):
            assert float(g) == pytest.approx(float(j), rel=1e-4, abs=1e-5)
    # a batch of point sets: each set as fitted alone
    batch = tfits.fit_circle(torch.from_numpy(np.stack([noisy, noisy * 2])))
    alone = tfits.fit_circle(torch.from_numpy(noisy * 2))
    for b, a in zip(batch, alone):
        assert float(b[1]) == pytest.approx(float(a), rel=1e-6)


def test_first_hit_matches_jax(bone):
    verts, v32, f32, _ = bone
    origin = verts.mean(0).astype(np.float32)
    direction = np.float32([1.0, 0.0, 0.0])
    pt, t, hit = jrays.first_hit(v32, f32, origin, direction)
    got = trays.first_hit(*_t(v32, f32, origin, direction))
    assert bool(got[2]) and bool(hit)
    assert np.allclose(got[0].numpy(), np.asarray(pt), atol=1e-4)
    assert float(got[1]) == pytest.approx(float(t), abs=1e-4)

    # from outside the bone the ray crosses the near wall, then the far
    # one; with the near wall's faces left out it hits the far wall
    outside = origin - 60.0 * direction
    near_pt, near_t, _ = jrays.first_hit(v32, f32, outside, direction)
    valid = np.linalg.norm(v32[f32[:, 0]] - np.asarray(near_pt),
                           axis=1) > 5.0
    want = jrays.first_hit(v32, f32, outside, direction, valid)
    got = trays.first_hit(*_t(v32, f32, outside, direction, valid))
    assert bool(want[2]) and float(want[1]) > float(near_t) + 5.0
    assert bool(got[2])
    assert np.allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-4)
    got_r = trays.first_hits(*_t(v32, f32, outside[None], direction[None],
                                 valid))
    assert torch.equal(got_r[0][0], got[0])
    # no valid face: no hit, the origin back and t = inf
    none = trays.first_hit(*_t(v32, f32, origin, direction,
                               np.zeros(len(f32), bool)))
    assert not bool(none[2]) and float(none[1]) == np.inf
    assert np.array_equal(none[0].numpy(), origin)
