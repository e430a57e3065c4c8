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

from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.host import obb
from shoulder_tpu_torch.io import ingest, native, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.models import ct_unet, unet
from shoulder_tpu_torch.ops import chain_walk, marching_tets
from shoulder_tpu_torch.ops import slicing as tsl
from shoulder_tpu_torch.pipeline import ct
from shoulder_tpu_torch.utils import geometry as geom

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
    before = chain_walk.launch_count
    got = chain_walk.chain_walk_marked(succ, crossed)
    torch.cuda.synchronize()
    assert chain_walk.launch_count == before + 1
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
    before = tsl.launch_count
    got = tsl.slice_stack(sg, zs, sset.interp_num, sset.band,
                          CFG.slice_compact_k)
    torch.cuda.synchronize()
    assert tsl.launch_count == before + 1
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
    before = tsl.launch_count
    got = tsl.slice_stack(sg, zs, sset.interp_num, sset.band,
                          CFG.slice_compact_k)
    assert tsl.launch_count == before + 1
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
        before = tsl.raw_launch_count
        got = tsl.slice_raw_banded(sg, z, band, max_chain, select, k=k)
        assert tsl.raw_launch_count == before + 1
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
