"""The port on a CUDA card: each kernel, and the card's half of the CT
path, against the port's own plain version or the CPU.

This file imports no JAX (the card's machine has none), so it runs there
without the suite's conftest.py, which imports jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q -p no:cacheprovider

Without a card every test skips.  The native-ingest case runs on the
card's host CPU, where the native library is built for that CPU.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.host import obb
from shoulder_tpu_torch.io import ingest, native, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.models import ct_unet, segment, unet
from shoulder_tpu_torch.ops import chain_walk, kernels, marching_tets, sphere
from shoulder_tpu_torch.ops import slicing as tsl
from shoulder_tpu_torch.pipeline import ct
from shoulder_tpu_torch.utils import geometry as geom
from shoulder_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

CFG = tiny_config()
STACKS = ["full", "proximal", "distal"]
TOL_MM = 1e-4
# tests/test_torch_ct.py's coarse volume
COARSE = dict(shape=(107, 48, 48), spacing=(3.0, 3.0, 3.0), seed=1,
              noise_hu=15.0, head_radius=26.0, shaft_radius=10.0,
              metaphysis_scale=0.6, groove_depth=4.5, groove_width_deg=20.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_rows(seed, k, n_rows):
    """Rows of random disjoint loops over front-packed slots (the cases of
    tests/test_torch_walk.py)."""
    rng = np.random.default_rng(seed)
    succ = np.tile(np.arange(k, dtype=np.int32), (n_rows, 1))
    crossed = np.zeros((n_rows, k), np.int32)
    for r in range(n_rows):
        sizes = rng.integers(3, 30, size=rng.integers(1, 4)).tolist()
        while sum(sizes) > k - 4:
            sizes = sizes[:-1]
        perm = rng.permutation(sum(sizes))
        i = 0
        for sz in sizes:
            loop = perm[i:i + sz]
            succ[r, loop] = np.roll(loop, -1)
            i += sz
        crossed[r, :sum(sizes)] = 1
    return succ, crossed


@pytest.fixture(scope="module")
def tiny_bone(tmp_path_factory):
    """tests/conftest.py's tiny bone, through the port's own ingest."""
    v, f = synthetic_humerus(rng_transform=np.random.default_rng(1),
                             n_rings=40, n_theta=32)
    path = tmp_path_factory.mktemp("bones") / "tiny.stl"
    stl.write_stl(path, v, f)
    return path


def test_cuda_kernel_matches_plain_walk(card):
    succ, crossed = (torch.as_tensor(a, device=card)
                     for a in _random_rows(3, k=384, n_rows=600))
    before = trace.counter("launches.chain_walk")
    got = chain_walk.chain_walk_marked(succ, crossed)
    torch.cuda.synchronize()
    assert trace.counter("launches.chain_walk") == before + 1
    want = chain_walk.chain_walk_plain(succ, crossed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _edge_planes(v_obb, n_verts):
    """Empty planes above and below the bone, planes at exact vertex
    heights, and ordinary planes between (tests/test_torch_slice_kernel.py)."""
    z = v_obb[:n_verts, 2]
    zlo, zhi = float(z.min()), float(z.max())
    zv = np.sort(z)[len(z) // 9:: len(z) // 7][:6]
    return np.concatenate([
        [zhi + 5.0, zhi + 1e-3, zlo - 1e-3, zlo - 5.0], zv,
        np.linspace(0.9 * zhi, 0.9 * zlo, 4),
    ]).astype(np.float32)


@pytest.mark.parametrize("stack", STACKS)
def test_cuda_kernel_matches_plain_slice_stack(card, tiny_bone, stack):
    spec = ingest.load_bone(tiny_bone, config=CFG)
    v_obb = geom.transform_pts(torch.as_tensor(spec.vertices),
                               torch.as_tensor(spec.obb_transform,
                                               dtype=torch.float32))
    sg = tsl.sorted_geom(*(torch.as_tensor(a, device=card) for a in (
        v_obb.numpy(), spec.faces, spec.neighbors, spec.face_orig)))
    sset = getattr(CFG, stack)
    zs = torch.as_tensor(_edge_planes(v_obb.numpy(), spec.n_verts),
                         device=card)
    before = trace.counter("launches.slice_stack")
    got = tsl.slice_stack(sg, zs, sset.interp_num, sset.band,
                          CFG.slice_compact_k)
    torch.cuda.synchronize()
    assert trace.counter("launches.slice_stack") == before + 1
    band = min(sset.band, sg.z_key.shape[0])
    want = tsl.slice_stack_plain(sg, zs, sset.interp_num, band,
                                 min(CFG.slice_compact_k, band))
    got, want = (tsl.SliceStack(*(x.cpu().numpy() for x in s))
                 for s in (got, want))
    assert np.array_equal(got.overflow, want.overflow)
    assert np.array_equal(got.open_edges, want.open_edges)
    ok = ~want.overflow
    # tolerances of tests/test_slice_kernel.py::test_walk_path_matches_doubling
    assert np.allclose(got.areas[ok], want.areas[ok], atol=0.01)
    assert np.allclose(got.total_areas[ok], want.total_areas[ok], atol=0.01)
    assert np.allclose(got.centroids[ok], want.centroids[ok], atol=1e-3)
    assert np.allclose(got.contours[ok], want.contours[ok], atol=1e-3)


@pytest.mark.parametrize("stack", STACKS + ["k64"])
def test_cuda_kernel_walk_matches_plain_walk(card, tiny_bone, stack):
    """The fused kernel's own walk (its timed build hands it out) equals
    the plain walk of the plain compaction's rows exactly: n, the face and
    the loop-start mark below n, -1 past n; k 64 overflows."""
    spec = ingest.load_bone(tiny_bone, config=CFG)
    v_obb = geom.transform_pts(torch.as_tensor(spec.vertices),
                               torch.as_tensor(spec.obb_transform,
                                               dtype=torch.float32))
    sg = tsl.sorted_geom(*(torch.as_tensor(a, device=card) for a in (
        v_obb.numpy(), spec.faces, spec.neighbors, spec.face_orig)))
    sset = getattr(CFG, "full" if stack == "k64" else stack)
    zhi, zlo = float(v_obb[:, 2].max()), float(v_obb[:, 2].min())
    zs = torch.cat([
        torch.linspace(0.99 * zhi, 0.99 * zlo, sset.zslice_num),
        torch.as_tensor(_edge_planes(v_obb.numpy(), spec.n_verts)),
    ]).to(card)
    band = min(sset.band, sg.z_key.shape[0])
    k = 64 if stack == "k64" else min(CFG.slice_compact_k, band)
    rows = zs.numel()
    walk = torch.empty((rows, k), dtype=torch.int32, device=card)
    n = torch.empty((rows,), dtype=torch.int32, device=card)
    tsl.slice_stack_kernel(sg, zs, sset.interp_num, band, k, walk=(walk, n))
    crossed, _s, _e, succ, _o, over, _open = tsl.compact_stack(sg, zs, band,
                                                               k)
    order, want_n, is_start = chain_walk.chain_walk_plain(
        succ.to(torch.int32).contiguous(), crossed.to(torch.int32).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(n, want_n)
    below = torch.arange(k, device=card) < n[:, None].long()
    assert torch.equal(torch.where(below, walk % k, 0),
                       torch.where(below, order, 0))
    assert torch.equal(below & (walk >= k), below & is_start)
    assert bool((walk[~below] == -1).all())
    assert int(n.sum()) > 10 * rows
    if stack == "k64":
        assert bool(over.any())


def test_cuda_batched_launch_equals_per_bone_launches(card, tmp_path):
    """Three distinct bones in one launch (one block per (bone, plane))
    give each bone what its own launch gives, bit for bit, and agree with
    the batched plain composition."""
    specs = []
    for i, side in enumerate(("left", "right", "left")):
        v, f = synthetic_humerus(side=side, n_rings=40, n_theta=32,
                                 rng_transform=np.random.default_rng(40 + i))
        stl.write_stl(tmp_path / f"b{i}.stl", v, f)
        specs.append(ingest.load_bone(tmp_path / f"b{i}.stl", config=CFG))
    from shoulder_tpu_torch.pipeline import batch as B

    bones = B.stack_bones(specs, card)
    v_obb = geom.transform_pts(bones.verts, bones.obb_transform)
    sg = tsl.sorted_geom(v_obb, bones.faces, bones.neighbors, bones.face_orig)
    sset = CFG.proximal
    zs = geom.linspace(0.95 * bones.z_max, 0.95 * bones.z_min,
                       sset.zslice_num)
    band = min(sset.band, sg.z_key.shape[-1])
    k = min(CFG.slice_compact_k, band)
    before = trace.counter("launches.slice_stack")
    got = tsl.slice_stack(sg, zs, sset.interp_num, sset.band,
                          CFG.slice_compact_k)
    assert trace.counter("launches.slice_stack") == before + 1
    for b in range(len(specs)):
        one = tsl.slice_stack_kernel(tsl.SortedGeom(*(x[b] for x in sg)),
                                     zs[b], sset.interp_num, band, k)
        for name, g, w in zip(tsl.SliceStack._fields, got, one):
            assert torch.equal(g[b], w), (b, name)
    want = tsl.slice_stack_plain(sg, zs, sset.interp_num, band, k)
    assert torch.equal(got.overflow, want.overflow)
    assert torch.equal(got.open_edges, want.open_edges)
    ok = ~want.overflow
    assert torch.allclose(got.areas[ok], want.areas[ok], atol=0.01)
    assert torch.allclose(got.contours[ok], want.contours[ok], atol=1e-3)


def test_ct_path_card_matches_cpu(card):
    """The card's marching tets and UNet against the port's CPU ones."""
    vol, origin, spacing = ct.synth_ct_volume(**COARSE)
    args = (300.0, tuple(map(float, origin)), tuple(map(float, spacing)))
    want = marching_tets.marching_tets(torch.as_tensor(vol), *args)
    got = marching_tets.marching_tets(torch.as_tensor(vol, device=card),
                                      *args)
    n = int(want.count)
    assert int(got.count) == n
    assert float((got.triangles.cpu() - want.triangles).abs().max()) <= TOL_MM
    w_got, w_want = (native.weld_soup(t.triangles[:n].cpu().numpy())
                     for t in (got, want))
    assert [len(x) for x in w_got[:3]] == [len(x) for x in w_want[:3]]
    assert w_got[3] == w_want[3]
    seg_cpu, _ = ct.segment_volume(vol, "unet", device="cpu")
    seg_card, _ = ct.segment_volume(vol, "unet", device=card)
    assert ((seg_card.cpu() > 0) == (seg_cpu > 0)).float().mean() >= 0.999


def test_native_ingest_on_the_card_host(card, tmp_path, monkeypatch):
    """The native ingest built for the card's host CPU against the numpy
    oracle on a full-size bone: mesh, presorted faces and face order
    equal, the box within 1e-6."""
    v, f = synthetic_humerus(rng_transform=np.random.default_rng(0))
    path = tmp_path / "bone.stl"
    stl.write_stl(path, v, f)
    before = (native.ingest_count, native.obb_count)
    got = ingest.load_bone(path)
    assert (native.ingest_count, native.obb_count) == (before[0] + 1,
                                                      before[1] + 1)
    mesh = stl.load_indexed_numpy(path)
    monkeypatch.setattr(obb, "oriented_bounds", obb.oriented_bounds_numpy)
    want = ingest.spec_from_arrays(path.stem, *mesh)
    assert native.obb_count == before[1] + 1
    for name in ("vertices_raw", "faces_raw", "neighbors_raw", "vertices",
                 "faces", "neighbors", "face_orig"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert np.abs(got.obb_transform - want.obb_transform).max() < 1e-6
    assert np.abs(np.subtract(got.z_bounds, want.z_bounds)).max() < 1e-6


@pytest.mark.parametrize("dims", [2, 3])
def test_cuda_bf16_conv_rounds_once(card, dims):
    """The UNets' bf16 convolutions on the card round their output once
    (models/unet._RoundOnce): at the bf16 floor of a float64 reference on
    the same operands, and equal to the CPU's (oneDNN's) on all but the
    outputs whose float32 sums fall on a rounding tie in another order."""
    torch.manual_seed(dims)
    if dims == 2:
        conv = unet.CastConv2d(16, 16, 3, padding=(1, 0))
        x = torch.randn(2, 16, 64, 66)
    else:
        conv = ct_unet.CastConv3d(8, 8, 3, padding=1)
        x = torch.randn(1, 8, 16, 24, 24)
    with torch.no_grad():
        conv.bias.normal_(0.0, 1.0)
        cpu = conv(x)
        got = conv.to(card)(x.to(card)).cpu()
    bf = torch.bfloat16
    ref = conv.cpu()._conv_forward(x.to(bf).double(),
                                   conv.weight.to(bf).double(),
                                   conv.bias.to(bf).double())

    def err(y):
        return float((y.double() - ref).norm() / ref.norm())

    assert got.dtype == bf
    assert err(got) <= 1.01 * err(ref.to(bf))
    assert float((got != cpu).double().mean()) < 1e-3


def _merging_rows(seed, k, n_rows):
    """Successor rows of every kind the walk takes: in even rows a random
    map (chains merge), in odd rows a random permutation (cycles); then a
    tenth of the slots is cut (its own successor, out of range at K or
    beyond, or negative), and nc is random in [0, K]."""
    rng = np.random.default_rng(seed)
    slots = np.arange(k)
    succ = rng.integers(0, k, size=(n_rows, k))
    succ[1::2] = np.stack([rng.permutation(k) for _ in range(n_rows // 2)])
    u = rng.random((n_rows, k))
    succ = np.where(u < 0.04, slots, succ)
    succ = np.where((u >= 0.04) & (u < 0.07),
                    k + rng.integers(0, k, size=(n_rows, k)), succ)
    succ = np.where((u >= 0.07) & (u < 0.1),
                    -1 - rng.integers(0, 3, size=(n_rows, k)), succ)
    nc = rng.integers(0, k + 1, size=n_rows)
    return (succ.astype(np.int32),
            (slots < nc[:, None]).astype(np.int32))


@pytest.mark.parametrize("k", [7, 384, 2048])
def test_cuda_walk_of_merging_rows_matches_plain(card, k):
    """The walk kernel against the plain walk, exactly, on rows whose
    chains merge, cycle, leave nc, leave the row or reach a negative
    successor, and on random loop rows; k up to chain_walk_max_k."""
    for succ, crossed in (_merging_rows(5, k, 64),
                          _random_rows(6, k=k, n_rows=64)):
        succ, crossed = (torch.as_tensor(a, device=card)
                         for a in (succ, crossed))
        got = chain_walk.chain_walk_marked(succ, crossed)
        want = chain_walk.chain_walk_plain(succ, crossed)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.fixture(scope="module")
def four_bones(tmp_path_factory):
    """Four distinct tiny bones, their batched SortedGeom on the card and
    their z range (B,)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shoulder_tpu_torch.pipeline import batch as B

    tmp = tmp_path_factory.mktemp("raw")
    specs = []
    for i, side in enumerate(("left", "right", "left", "right")):
        v, f = synthetic_humerus(side=side, n_rings=40, n_theta=32,
                                 rng_transform=np.random.default_rng(60 + i))
        stl.write_stl(tmp / f"b{i}.stl", v, f)
        specs.append(ingest.load_bone(tmp / f"b{i}.stl", config=CFG))
    bones = B.stack_bones(specs, "cuda")
    v_obb = geom.transform_pts(bones.verts, bones.obb_transform)
    sg = tsl.sorted_geom(v_obb, bones.faces, bones.neighbors, bones.face_orig)
    return sg, bones.z_min, bones.z_max


def _assert_raw_equal(got, want, loops_equal=True):
    """n and overflow equal, points within 1e-5 mm; with loops_equal the
    same loop (area within 0.01 mm^2, centroid within 1e-3 mm)."""
    (g, g_over), (w, w_over) = got, want
    assert torch.equal(g_over, w_over)
    assert torch.equal(g.n, w.n)
    assert float((g.points - w.points).abs().max()) <= 1e-5
    if loops_equal:
        assert float((g.area - w.area).abs().max()) <= 0.01
        assert float((g.centroid - w.centroid).abs().max()) <= 1e-3


# (band, k, max_chain) of the raw-loop kernel's two launch shapes: the
# main path's tiny-config planes (k 512, a block of 512 threads) and the CT
# sizes (band 6144, k 1024, max_chain 1024, a block of 1024 threads)
RAW_SHAPES = {"main": (CFG.full.band, 512, CFG.max_chain),
              "ct": (6144, 1024, 1024)}


@pytest.mark.parametrize("shape", sorted(RAW_SHAPES))
@pytest.mark.parametrize("select", tsl.SELECTS)
def test_cuda_raw_loop_matches_plain(card, four_bones, select, shape):
    """The raw-loop kernel, one launch for 4 bones, against the plain
    composition on the card at three heights, and each bone's own launch
    bit for bit."""
    sg, z_min, z_max = four_bones
    band, k, max_chain = RAW_SHAPES[shape]
    band = min(band, sg.z_key.shape[-1])
    for rel in (0.3, 0.55, 0.8):
        z = (z_min + rel * (z_max - z_min)).contiguous()
        before = trace.counter("launches.slice_raw")
        got = tsl.slice_raw_banded(sg, z, band, max_chain, select, k=k)
        assert trace.counter("launches.slice_raw") == before + 1
        k = min(k, band)
        want = tsl.slice_raw_banded_plain(sg, z, band, max_chain, select, k)
        torch.cuda.synchronize()
        _assert_raw_equal(got, want)
        assert int(got[0].n.min()) > 10
        for b in range(z.shape[0]):
            one = tsl.slice_raw_kernel(tsl.SortedGeom(*(x[b:b + 1] for x in sg)),
                                       z[b:b + 1], band, max_chain, select, k)
            for g, w in zip((*got[0], got[1]), (*one[0], one[1])):
                assert torch.equal(g[b:b + 1], w)


@pytest.mark.parametrize("shape", sorted(RAW_SHAPES))
@pytest.mark.parametrize("select", tsl.SELECTS)
def test_cuda_raw_loop_overflow_matches_plain(card, four_bones, select,
                                              shape):
    """k 24 below the planes' crossing counts: the chains break and their
    ranks run past the count; the kernel places every point where the
    plain composition does, those past n included."""
    sg, z_min, z_max = four_bones
    band, _k, max_chain = RAW_SHAPES[shape]
    band = min(band, sg.z_key.shape[-1])
    z = (z_min + 0.55 * (z_max - z_min)).contiguous()
    got = tsl.slice_raw_banded(sg, z, band, max_chain, select, k=24)
    want = tsl.slice_raw_banded_plain(sg, z, band, max_chain, select, 24)
    torch.cuda.synchronize()
    assert bool(want[1].all())
    _assert_raw_equal(got, want, loops_equal=False)
    past = torch.arange(max_chain, device=card) >= want[0].n[:, None]
    assert float(want[0].points[past].abs().sum()) > 0


@pytest.mark.parametrize("shape", sorted(RAW_SHAPES))
def test_cuda_raw_loop_timed_build(card, four_bones, shape):
    """The timed build gives the untimed kernel's result bit for bit, and
    stamps that run forward through every stage."""
    sg, z_min, z_max = four_bones
    band, k, max_chain = RAW_SHAPES[shape]
    band = min(band, sg.z_key.shape[-1])
    z = (z_min + 0.55 * (z_max - z_min)).contiguous()
    args = (sg, z, band, max_chain, "central", min(k, band))
    stamps = torch.zeros((z.shape[0], len(tsl.RAW_STAGES) + 3),
                         dtype=torch.int64, device=card)
    timed = tsl.slice_raw_kernel(*args, stamps=stamps)
    plain = tsl.slice_raw_kernel(*args)
    torch.cuda.synchronize()
    for g, w in zip((*timed[0], timed[1]), (*plain[0], plain[1])):
        assert torch.equal(g, w)
    us, ghz = tsl.stage_times(stamps)
    assert us.shape == (z.shape[0], len(tsl.RAW_STAGES))
    assert bool((us >= 0).all()) and 0.5 < ghz < 3.0


# the sphere kernels (csrc/sphere_score.cu, csrc/sphere_fit.cu) at
# DEFAULT_CONFIG's polar image, 512 x 512 points a bone: the scores of the
# hypotheses a pick may take within a relative 1e-5 (below one point's
# weight, 1e-5 absolute), each fit's sphere within 1e-3 mm of the plain
# version on the card
SPHERE_RC = (512, 512)


def _domes(n_bones, seed=0, r=SPHERE_RC[0], c=SPHERE_RC[1]):
    """(B, R, C, 3) float32 polar points: a noisy spherical dome of
    random centre and radius on a flared shaft, one per bone."""
    rng = np.random.default_rng(seed)
    th = np.linspace(-np.pi, np.pi, c, endpoint=False)
    out = []
    for _ in range(n_bones):
        cen = np.array([*rng.normal(0, 2, 2), 275.0])
        rad0 = rng.uniform(21.0, 26.0)
        z = np.linspace(cen[2] + rad0, cen[2] - 2.5 * rad0, r)
        rad = np.sqrt(np.clip(rad0**2 - (z - cen[2]) ** 2, 0, None))
        rad = np.where(z > cen[2] - 0.5 * rad0, rad,
                       0.6 * rad0 + 0.1 * (cen[2] - z))
        rad = (rad[:, None]
               + 1.5 * np.cos(3 * th)[None] * (z < cen[2])[:, None])
        rad = rad + rng.normal(0, 0.05, (r, c))
        out.append(np.stack([cen[0] + rad * np.cos(th)[None],
                             cen[1] + rad * np.sin(th)[None],
                             np.broadcast_to(z[:, None], (r, c))], -1))
    return np.stack(out).astype(np.float32)


def _sphere_case(card, n_bones=3, seed=0):
    """(pts (B, P, 3), w_row (P,), h_rad (B, H), h_cen (B, H, 3)) on the
    card: the RANSAC spheres of the main path's draw and two more."""
    r, c = SPHERE_RC
    pts = torch.as_tensor(_domes(n_bones, seed), device=card).reshape(
        n_bones, r * c, 3)
    hyp = segment.ransac_indices(int(0.4 * r) * c, card)
    quads = pts.index_select(1, hyp.reshape(-1)).reshape(n_bones, -1, 4, 3)
    a4 = torch.cat([2.0 * quads, torch.ones_like(quads[..., :1])], -1)
    sol = torch.linalg.solve_ex(a4, torch.sum(quads**2, -1)).result
    h_cen = torch.cat([sol[..., :3], pts[:, :2]], 1).contiguous()
    h_rad = torch.cat([torch.sqrt(torch.clamp(
        sol[..., 3] + torch.sum(sol[..., :3] ** 2, -1), min=1e-9)),
        torch.full((n_bones, 2), 24.0, device=card)], 1).contiguous()
    t = torch.clamp((torch.arange(r * c, device=card) // c - 0.45 * r)
                    / (0.3 * r), 0.0, 1.0)
    return pts, 1.0 - 0.8 * t * t * (3.0 - 2.0 * t), h_rad, h_cen


@pytest.mark.parametrize("scale", ["number", "per_bone"])
def test_cuda_sphere_score_matches_plain(card, scale):
    pts, w_row, h_rad, h_cen = _sphere_case(card)
    s = 0.7 if scale == "number" else torch.tensor([0.7, 1.2, 2.0],
                                                   device=card)
    before = trace.counter("launches.sphere_score")
    got = sphere.scores(pts, w_row, h_rad, h_cen, s)
    want = sphere.score_plain(pts, w_row, h_rad, h_cen, s)
    torch.cuda.synchronize()
    assert trace.counter("launches.sphere_score") == before + 1
    assert torch.equal(torch.isfinite(want), torch.isfinite(got))
    ok = torch.isfinite(want) & sphere.pickable(h_rad, h_cen)
    assert float(want[ok].max()) > 1e3
    rel = (got[ok] - want[ok]).abs() / want[ok].abs().clamp(min=1.0)
    assert float(rel.max()) <= 1e-5


@pytest.mark.parametrize("kind", ["given", "given_shared", "tukey", "sigma"])
def test_cuda_sphere_fit_matches_plain(card, kind):
    pts, _, h_rad, h_cen = _sphere_case(card)
    eye4 = torch.eye(4, device=card)
    radius, center = h_rad[:, -1].contiguous(), h_cen[:, 0].contiguous()
    scale = torch.tensor([1.0, 1.5, 0.7], device=card)
    before = trace.counter("launches.sphere_fit")
    if kind.startswith("given"):
        w = (torch.rand(pts.shape[:2], generator=torch.Generator(
            device=card).manual_seed(3), device=card) < 0.3).float()
        if kind == "given_shared":
            w = w[0].expand_as(w)
        got = sphere.fit_moments(pts, w)
        want = sphere.moments_plain(pts, w)
    elif kind == "tukey":
        w_heur = (torch.arange(pts.shape[1], device=card) // SPHERE_RC[1]
                  < 0.3 * SPHERE_RC[0]).float().expand(pts.shape[:2])
        heur = sphere.moments_plain(pts, w_heur)
        got = sphere.irls_moments(pts, radius, center, scale, w_heur, heur)
        want = sphere.irls_moments_plain(pts, radius, center, scale, w_heur)
    else:
        got = sphere.sigma_sums(pts, radius, center, 1.0)
        want = sphere.sigma_sums_plain(pts, radius, center, 1.0)
    torch.cuda.synchronize()
    assert (trace.counter("launches.sphere_fit")
            == before + (1 if kind == "sigma" else 2))
    if kind == "sigma":
        assert float(want[0].min()) > 100.0
        for g, w_ in zip(got, want):
            assert float(((g - w_).abs() / w_.abs()).max()) <= 1e-5
        return
    g_r, g_c = sphere.solve(*got, eye4)
    w_r, w_c = sphere.solve(*want, eye4)
    assert float((g_r - w_r).abs().max()) <= 1e-3
    assert float((g_c - w_c).abs().max()) <= 1e-3


def test_cuda_sphere_kernels_are_batch_invariant(card):
    """Each bone's scores, sums and moments alone equal its row of the
    batched launch bit for bit."""
    pts, w_row, h_rad, h_cen = _sphere_case(card)
    radius, center = h_rad[:, -1].contiguous(), h_cen[:, 0].contiguous()
    scale = torch.tensor([1.0, 1.5, 0.7], device=card)
    w = pts[..., 2] > pts[..., 2].mean(dim=-1, keepdim=True)
    w = w.float()
    batch = [sphere.sphere_score_kernel(pts, w_row, h_rad, h_cen, scale),
             *sphere.sphere_fit_kernel(pts, sphere.GIVEN, w=w),
             *sphere.sphere_fit_kernel(pts, sphere.TUKEY, radius=radius,
                                       center=center, scale=scale),
             sphere.sphere_fit_kernel(pts, sphere.SIGMA, radius=radius,
                                      center=center, scale=0.9)[0]]
    for b in range(pts.shape[0]):
        one = slice(b, b + 1)
        alone = [sphere.sphere_score_kernel(pts[one], w_row, h_rad[one],
                                            h_cen[one], scale[one]),
                 *sphere.sphere_fit_kernel(pts[one], sphere.GIVEN,
                                           w=w[one]),
                 *sphere.sphere_fit_kernel(pts[one], sphere.TUKEY,
                                           radius=radius[one],
                                           center=center[one],
                                           scale=scale[one]),
                 sphere.sphere_fit_kernel(pts[one], sphere.SIGMA,
                                          radius=radius[one],
                                          center=center[one], scale=0.9)[0]]
        for g, w_ in zip(alone, batch):
            assert torch.equal(g, w_[one])


def test_cuda_sphere_refused_launch_raises(card):
    """Arguments the kernels cannot take: the C entry points refuse them
    and launch nothing (cudaErrorInvalidValue), and the wrappers raise
    on a refused launch."""
    pts, w_row, h_rad, h_cen = _sphere_case(card, n_bones=1)
    lib = kernels.library()
    out = torch.empty(1, 300, device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    rc = lib.sphere_score_launch(
        pts.data_ptr(), w_row.data_ptr(), h_rad.data_ptr(), h_cen.data_ptr(),
        None, 1.0, out.data_ptr(), out.data_ptr(), out.data_ptr(),
        pts.shape[1], 1, 300, card.index or 0, stream)
    assert rc == 1
    rc = lib.sphere_fit_launch(
        pts.data_ptr(), None, 0, h_cen.data_ptr(), h_rad.data_ptr(), None,
        1.0, 2, sphere.SIGMA, out.data_ptr(), out.data_ptr(),
        out.data_ptr(), out.data_ptr(), out.data_ptr(), pts.shape[1], 1,
        card.index or 0, stream)
    assert rc == 1

    class Refusing:
        """The library, with every launch's hypothesis count or pass made
        one the kernel refuses."""

        def __getattr__(self, name):
            return getattr(lib, name)

        def sphere_score_launch(self, *args):
            return lib.sphere_score_launch(*args[:11], 300, *args[12:])

        def sphere_fit_launch(self, *args):
            return lib.sphere_fit_launch(*args[:7], 2, sphere.SIGMA,
                                         *args[9:])

    before = (trace.counter("launches.sphere_score"),
              trace.counter("launches.sphere_fit"))
    with pytest.raises(RuntimeError, match="sphere_score kernel launch"):
        sphere.sphere_score_kernel(pts, w_row, h_rad, h_cen, 1.0,
                                   lib=Refusing())
    with pytest.raises(RuntimeError, match="sphere_fit kernel launch"):
        sphere.sphere_fit_kernel(pts, sphere.SIGMA, radius=h_rad[:, 0],
                                 center=h_cen[:, 0].contiguous(), scale=1.0,
                                 lib=Refusing())
    with pytest.raises(ValueError, match="hypotheses above"):
        sphere.sphere_score_kernel(pts, w_row,
                                   torch.full((1, 300), 24.0, device=card),
                                   torch.zeros(1, 300, 3, device=card), 1.0)
    assert (trace.counter("launches.sphere_score"),
            trace.counter("launches.sphere_fit")) == before
    torch.cuda.synchronize()


def test_cuda_sphere_segment_matches_plain(card):
    """sphere_segment through the kernels against the same call through
    the plain versions on the card: every sphere within 1e-3 mm, every
    mask on 99.9 % of its pixels, and the counts of one call."""
    r, c = SPHERE_RC
    pts = torch.as_tensor(_domes(2, seed=4), device=card)
    hyp = segment.ransac_indices(int(0.4 * r) * c, card)
    sup = torch.zeros(2, r, c, device=card)
    sup[:, : int(0.45 * r)] = 1.0
    before = (trace.counter("launches.sphere_score"),
              trace.counter("launches.sphere_fit"))
    got = segment.sphere_segment(pts, hyp, 12, 2.0, 0.3, init_mask=sup,
                                 support_mask=sup)
    assert (trace.counter("launches.sphere_score") - before[0],
            trace.counter("launches.sphere_fit") - before[1]) == (2, 30)
    with chip_smoke.plain_sphere():
        want = segment.sphere_segment(pts, hyp, 12, 2.0, 0.3, init_mask=sup,
                                      support_mask=sup)
    torch.cuda.synchronize()
    agree = (got[0] == want[0]).float().mean(dim=(-2, -1))
    assert float(agree.min()) >= 0.999
    assert float((got[1] - want[1]).abs().max()) <= 1e-3
    assert float((got[2] - want[2]).abs().max()) <= 1e-3


# ---- CUDA graphs over the landmark stages (pipeline/graphs.py) -----------

# the graphed calls of one batch with the UNet segmenter: sorted_geom, three
# slice stacks, the surgical neck, canal, groove, anatomic-neck image
# points, UNet, mask fits, transepicondylar axis and metrics
GRAPHED_CALLS = 12
GRAPH_CASES = {  # (config, bones a batch, distinct batches)
    "batch8": (None, 8, 4),
    "batch1": (None, 1, 3),
    "ct4": ("ct", 4, 2),
}


def _graph_batches(tmp_path, case):
    from shoulder_tpu_torch.config import DEFAULT_CONFIG, DENSE_CONFIG
    from shoulder_tpu_torch.pipeline import batch as B

    cfg_name, n, n_batches = GRAPH_CASES[case]
    cfg = DENSE_CONFIG if cfg_name == "ct" else DEFAULT_CONFIG
    specs = []
    for i in range(n * n_batches):
        v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                 rng_transform=np.random.default_rng(70 + i))
        stl.write_stl(tmp_path / f"g{i}.stl", v, f)
        specs.append(ingest.load_bone(tmp_path / f"g{i}.stl", config=cfg))
    return cfg, [B.stack_bones(specs[j * n:(j + 1) * n], "cuda")
                 for j in range(n_batches)]


def _landmarks_np(lm):
    return [x.cpu().numpy() for x in lm]


def _same_bits(got, want):
    return all(g.dtype == w.dtype and g.shape == w.shape
               and g.tobytes() == w.tobytes() for g, w in zip(got, want))


def _eager(batches, rf, cfg, seg):
    """Each batch's landmarks with the stages eager (no CUDA graph)."""
    from shoulder_tpu_torch.pipeline import landmarks as L

    return [_landmarks_np(L._stages(b, rf, False, cfg, 150, seg, None))
            for b in batches]


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_cuda_replayed_batches_equal_eager(card, tmp_path, case):
    """Distinct batches cycled twice through landmarks_batch: every
    Landmarks field of every call, read after all the calls (so call n's
    result outlives call n+1), equals the eager run bit for bit; one
    capture per graphed stage, replays after.  The kernel wrappers count
    the host's launches (the first call's eager run and its capture), and
    a replayed call runs each of the port's kernels a batch's times."""
    from torch.profiler import ProfilerActivity, profile

    from shoulder_tpu_torch.models import forest
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.pipeline import graphs
    from shoulder_tpu_torch.utils import bench

    cfg, batches = _graph_batches(tmp_path, case)
    rf, seg = forest.load_params(card), unet.load_model(card)
    graphs.clear()
    want = _eager(batches, rf, cfg, seg)
    trace.reset()
    kept = [B.compute_landmarks_batch(b, rf, cfg=cfg, seg_model=seg)
            for _ in range(2) for b in batches]
    torch.cuda.synchronize()
    for i, lm in enumerate(kept):
        assert _same_bits(_landmarks_np(lm), want[i % len(batches)]), i
    calls = len(kept)
    assert trace.counter("graphs.captures") == GRAPHED_CALLS
    assert trace.counter("graphs.replays") == GRAPHED_CALLS * (calls - 1)
    assert trace.counter("graphs.eager") == GRAPHED_CALLS  # the first call
    assert trace.counter("graphs.fallbacks") == 0
    assert (trace.counter("launches.slice_stack"),
            trace.counter("launches.slice_raw"),
            trace.counter("launches.sphere_score"),
            trace.counter("launches.sphere_fit")) == (6, 2, 2 * calls,
                                                      30 * calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        B.compute_landmarks_batch(batches[0], rf, cfg=cfg, seg_model=seg)
        torch.cuda.synchronize()
    assert bench.kernel_runs(prof) == {
        "launches.slice_stack": 3, "launches.slice_raw": 1,
        "launches.chain_walk": 0, "launches.sphere_score": 2,
        "launches.sphere_fit": 30}
    graphs.clear()


def test_cuda_failed_capture_falls_back_eagerly(card, tmp_path,
                                                monkeypatch):
    """A stage that reads the card on the host cannot be captured: it
    warns, counts one fallback, runs eagerly at that key from then on,
    and the batch's landmarks still equal the eager run's bit for bit."""
    from shoulder_tpu_torch.models import forest
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.pipeline import graphs

    cfg, batches = _graph_batches(tmp_path, "batch1")
    rf, seg = forest.load_params(card), unet.load_model(card)
    spherical = geom.unitxyz_to_spherical

    def host_read(xyz):  # used only by the metrics stage
        float(xyz.sum())
        return spherical(xyz)

    monkeypatch.setattr(geom, "unitxyz_to_spherical", host_read)
    graphs.clear()
    want = _eager(batches[:2], rf, cfg, seg)
    trace.reset()
    with pytest.warns(RuntimeWarning, match="_metrics"):
        first = B.compute_landmarks_batch(batches[0], rf, cfg=cfg,
                                          seg_model=seg)
    second = B.compute_landmarks_batch(batches[1], rf, cfg=cfg,
                                       seg_model=seg)
    assert _same_bits(_landmarks_np(first), want[0])
    assert _same_bits(_landmarks_np(second), want[1])
    assert trace.counter("graphs.fallbacks") == 1
    assert trace.counter("graphs.captures") == GRAPHED_CALLS - 1
    assert trace.counter("graphs.replays") == GRAPHED_CALLS - 1
    # the first call, the failed key's eager calls after its capture
    assert trace.counter("graphs.eager") == GRAPHED_CALLS + 2
    graphs.clear()


# the dense cell's bone (benchmark/configs/mesh_unet_dense.json): 480 rings
# x 256 sectors, 245,760 faces and 122,882 vertices
DENSE_MESH = dict(n_rings=480, n_theta=256)


@pytest.fixture(scope="module")
def dense_paths(tmp_path_factory):
    """STL files: a dense humerus, a dense proximal humerus, and a bone
    DEFAULT_CONFIG holds."""
    d = tmp_path_factory.mktemp("dense")
    out = {}
    for i, name in enumerate(("humerus", "proximal", "default")):
        mesh = DENSE_MESH if name != "default" else {}
        v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                 proximal_only=name == "proximal",
                                 rng_transform=np.random.default_rng(80 + i),
                                 **mesh)
        out[name] = d / f"{name}.stl"
        stl.write_stl(out[name], v, f)
    return out


def _same_tree(got, want):
    """Landmark dicts (nested, as the facade and the cohort give them)
    equal bit for bit."""
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(got[k], want[k])
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("entry", ["humerus", "proximal", "cohort", "ct"])
def test_cuda_entry_points_pad_dense_meshes(card, dense_paths, entry):
    """Without a config, a ~250k-face mesh runs at DENSE_CONFIG, bit for
    bit its run with DENSE_CONFIG named: the facade, the cohort (a dense
    bone at DENSE_CONFIG, the bones DEFAULT_CONFIG holds at it, bit for bit
    their cohort alone, rows in input order) and the CT path at 1.0 mm;
    each dense bone counts in ingest.dense."""
    from shoulder_tpu_torch import bone, cohort
    from shoulder_tpu_torch.config import DEFAULT_CONFIG, DENSE_CONFIG

    trace.reset(["ingest.dense"])
    if entry in ("humerus", "proximal"):
        cls = bone.Humerus if entry == "humerus" else bone.ProximalHumerus
        got = cls(dense_paths[entry])
        assert got._spec.config is DENSE_CONFIG
        assert trace.counter("ingest.dense") == 1
        _same_tree(got._landmarks(),
                   cls(dense_paths[entry], config=DENSE_CONFIG)._landmarks())
    elif entry == "cohort":
        paths = [dense_paths["humerus"], dense_paths["default"],
                 dense_paths["default"]]
        got = cohort.process_cohort(paths, batch_size=2)
        assert trace.counter("ingest.dense") == 1
        # the bone DEFAULT_CONFIG holds: its row beside a dense bone is its
        # row in a cohort of such bones alone
        sparse = cohort.process_cohort(paths[1:], batch_size=2)
        (dense,) = cohort.process_cohort(paths[:1], config=DENSE_CONFIG,
                                         batch_size=2)
        assert len(got) == 3
        for g, w in zip(got, (dense, sparse[0], sparse[1])):
            _same_tree(g, w)
    else:
        vol, origin, spacing = ct.synth_ct_volume(
            shape=chip_smoke.CT_SHAPE, spacing=(chip_smoke.CT_PITCH,) * 3,
            seed=1, noise_hu=15.0, **chip_smoke.CT_BONE_KW)
        lm, spec = ct.landmarks_from_volume(vol, origin, spacing)
        assert spec.config is DENSE_CONFIG
        assert spec.n_faces > DEFAULT_CONFIG.max_faces
        assert trace.counter("ingest.dense") == 1
        want, _ = ct.landmarks_from_volume(vol, origin, spacing,
                                           config=DENSE_CONFIG)
        assert _same_bits([np.asarray(x) for x in lm],
                          [np.asarray(x) for x in want])


def test_cuda_dense_cell_is_correct(card):
    """The cell mesh_unet_dense.batch8 end to end on the card at a small
    size (benchmark/tests/dense.py: a 12,288-face mesh past the small
    padding), against the plain reference."""
    from benchmark.tests import dense

    result, correct = dense.run(card)
    assert correct and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "gpu"


def test_cuda_pooled_cohort_gives_the_serial_rows(card, tmp_path,
                                                  monkeypatch):
    """process_cohort on the card over 16 synthetic STL files (40,960
    faces, DEFAULT_CONFIG, batches of 8): the pool of ingest threads the
    card's host sizes gives the rows of the serial prefetch (a pool of
    1), bit for bit and in the order of the paths."""
    from shoulder_tpu_torch import cohort

    paths = []
    for i in range(16):
        v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                 rng_transform=np.random.default_rng(90 + i))
        paths.append(tmp_path / f"bone{i:02d}.stl")
        stl.write_stl(paths[-1], v, f)
    assert cohort._pool_size(len(paths)) > 1
    with monkeypatch.context() as mp:
        mp.setattr(cohort, "_pool_size", lambda n: 1)
        serial = cohort.process_cohort(paths)
    trace.reset(["cohort.ingest_overlap", "cohort.bones_ingested"])
    pooled = cohort.process_cohort(paths)
    assert trace.counter("cohort.bones_ingested") == 16
    assert trace.counter("cohort.ingest_overlap") > 0
    assert [r["name"] for r in pooled] == [p.stem for p in paths]
    assert len(serial) == 16
    for g, w in zip(pooled, serial):
        _same_tree(g, w)
