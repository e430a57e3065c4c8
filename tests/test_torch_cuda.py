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
