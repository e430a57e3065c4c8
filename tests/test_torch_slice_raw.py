"""The surgical-neck raw loop: its wrapper, its argument checks, and the
raw-loop kernel's steps as a plain model.

`slicing.slice_raw_banded` takes the plain composition
(`slice_raw_banded_plain`) on CPU tensors and launches csrc/slice_raw.cu
on CUDA tensors; the kernel path refuses CPU tensors.  The kernel's steps
after the compaction (labels, per-label counts and exact fixed-point
per-label sums, the pick over present labels and the first empty one, the
smallest original face id, the pointer-jumping ranks with the largest
slot winning a collision) are stated here in PyTorch (`raw_kernel_model`)
and held against the plain composition: its sums against `_loop_stats`,
its loop and points against `raw_loop`, on the tiny bone's planes (k 24
overflows), at the CT shape (k 1024, band 6144, max_chain 1024) on a bone
whose neck loop is longer than 512 faces, and on rows built for the
pick's corner cases.  The kernel itself is held to the plain composition
on the card (tests/test_torch_cuda.py, chip_smoke.py phases 5b and 9).
"""

import numpy as np
import pytest
import torch

from shoulder_tpu.utils import geometry as jgeom
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.ops import slicing as tsl
from shoulder_tpu_torch.utils import trace

CFG = tiny_config()


@pytest.fixture(scope="module")
def tiny_sg(tiny_spec):
    """The tiny bone's SortedGeom as a batch of one, and its z range."""
    s = tiny_spec
    v = np.asarray(jgeom.transform_pts(s.vertices,
                                       s.obb_transform.astype(np.float32)))
    sg = tsl.sorted_geom(*(torch.as_tensor(np.array(a))[None] for a in (
        v, s.faces, s.neighbors, s.face_orig)))
    return sg, float(v[:, 2].min()), float(v[:, 2].max())


def _compaction(sg, z, band, k):
    """slice_raw_banded_plain's compaction of planes z (B,)."""
    lo, _starts, _over = tsl._window_starts(sg, z[:, None], band)
    lo = lo[:, 0]
    flat, base = tsl._flat(sg)
    zmm_w = flat.z_mm[(base + lo)[:, None] + torch.arange(band)]
    crossed, start, end, succ, orig, _o, _e = tsl._compact_slice(
        flat, zmm_w, lo, z, k, base)
    return crossed, start, end, succ, orig


def label_sums(lab, start, end, k):
    """The kernel's per-label sums, exact: each term of the crossed slots
    (labels below k) times 2^e rounded to an integer, e per row and kind
    from the largest |term| (max < 2^ex, e = 39 - ex - ceil(log2 k)), the
    integers summed per label (in any order: integer sums are exact), the
    sum rounded once to float32 and scaled back by 2^-e.  Returns (sums
    (B, k + 1, 5): cross, (x_s + x_e) * cross, (y_s + y_e) * cross, x_s,
    y_s; counts (B, k + 1))."""
    s, e = start, end
    cr2 = s[..., 0] * e[..., 1] - e[..., 0] * s[..., 1]
    v = torch.stack([cr2, (s[..., 0] + e[..., 0]) * cr2,
                     (s[..., 1] + e[..., 1]) * cr2, s[..., 0], s[..., 1]], -1)
    crossed = (lab < k)[..., None]
    _m, ex = torch.frexp(torch.where(crossed, v.abs(), 0.0).amax(dim=1))
    log2k = 0 if k < 2 else (k - 1).bit_length()
    scale = torch.pow(2.0, (39 - ex - log2k).double())[:, None, :]
    q = torch.where(crossed, torch.round(v.double() * scale), 0.0)
    fixed = torch.zeros((lab.shape[0], k + 1, 5), dtype=torch.int64)
    fixed.scatter_add_(1, lab[..., None].expand(-1, -1, 5), q.to(torch.int64))
    sums = (fixed.to(torch.float32).double() / scale).to(torch.float32)
    counts = torch.zeros((lab.shape[0], k + 1), dtype=torch.int64)
    counts.scatter_add_(1, lab, torch.ones_like(lab))
    return sums, counts


def raw_kernel_model(crossed, start, end, succ, orig, max_chain, select):
    """Steps 5-9 of csrc/slice_raw.cu on compacted rows (B, k): RawLoop
    and the picked label (B,)."""
    n_rows, k = succ.shape
    slots = torch.arange(k).expand(n_rows, k)
    succ = succ.to(torch.int64)
    orig = orig.to(torch.int64)
    rounds = tsl._iters_for(k)
    # 5. labels, exactly _iters_for(k) rounds
    lab, ptr = torch.where(crossed, slots, k), succ
    for _ in range(rounds):
        lab, ptr = (torch.where(lab < k, torch.minimum(lab, lab.gather(1, ptr)),
                                lab),
                    ptr.gather(1, ptr))
    # 6. per-label counts and exact sums
    sums, counts = label_sums(lab, start, end, k)
    sums, counts = sums[:, :k], counts[:, :k]
    area = 0.5 * sums[..., 0]
    present = counts > 0
    # 7. pick: (value, first label) over present labels and, for largest,
    # every empty label at area 0; central: label 0 where none counts
    if select == "largest":
        best = torch.argmax(torch.where(present, area, 0.0), dim=1)
    else:
        cnt = torch.clamp(counts, min=1).to(start.dtype)
        score = (torch.abs(sums[..., 3] / cnt) + torch.abs(sums[..., 4] / cnt))
        val = torch.where(counts >= 3, -score, -torch.inf)
        best = torch.where(torch.isfinite(val).any(1),
                           torch.argmax(val, dim=1), 0)
    pick = best[:, None]
    n_best = counts.gather(1, pick)[:, 0]
    a = area.gather(1, pick)[:, 0]
    denom = torch.where(torch.abs(a) > 1e-12, 6.0 * a, 1.0)
    cen = sums.gather(1, pick[..., None].expand(-1, -1, 5))[:, 0, 1:3] \
        / denom[:, None]
    a = torch.where(n_best > 0, a, 0.0)
    cen = torch.where((n_best > 0)[:, None], cen, 0.0)
    # 8. the loop's smallest original face id; its sums are the label's
    member = lab == pick
    min_orig = torch.where(member, orig, tsl._BIG).amin(dim=1, keepdim=True)
    rep = member & (orig == min_orig)
    # 9. ranks, exactly _iters_for(k) rounds; collisions to the largest slot
    ptr, rnk = torch.where(rep, slots, succ), torch.where(rep, 0, 1)
    for _ in range(rounds):
        rnk, ptr = rnk + rnk.gather(1, ptr), ptr.gather(1, ptr)
    q = torch.where(rep, 0, n_best[:, None] - rnk)
    q = torch.where(q < 0, q + max_chain, q)
    q = torch.where(member & (q >= 0) & (q < max_chain), q, max_chain)
    owner = torch.full((n_rows, max_chain + 1), -1, dtype=torch.int64)
    owner.scatter_reduce_(1, q, slots, reduce="amax")  # the kernel's atomicMax
    owner = owner[:, :max_chain]
    points = torch.where((owner >= 0)[..., None], start.gather(
        1, owner.clamp(min=0)[..., None].expand(-1, -1, 2)), 0.0)
    return tsl.RawLoop(points, n_best, a, cen), best


def _plain_best(crossed, start, end, succ, select):
    """The label the plain composition picks (its _loop_stats and argmax /
    argmin)."""
    k = succ.shape[1]
    lab = tsl._label_loops(crossed, succ)
    area, _c, count, mean_pt = tsl._loop_stats(crossed, start, end, lab, k)
    if select == "largest":
        return torch.argmax(area[:, :k], dim=1)
    score = torch.abs(mean_pt[:, :k, 0]) + torch.abs(mean_pt[:, :k, 1])
    return torch.argmin(torch.where(count[:, :k] >= 3, score, torch.inf), 1)


def _check_model(rows, max_chain, select):
    crossed, start, end, succ, orig = rows
    got, best = raw_kernel_model(crossed, start, end, succ, orig, max_chain,
                                 select)
    want = tsl.raw_loop(crossed, start, end, succ, orig, max_chain, select)
    assert torch.equal(best, _plain_best(crossed, start, end, succ, select))
    assert torch.equal(got.n, want.n)
    assert torch.equal(got.points, want.points)
    assert float((got.area - want.area).abs().max()) <= 1e-3
    assert float((got.centroid - want.centroid).abs().max()) <= 1e-4
    return got


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def long_loop_sg():
    """A bone of 64 rings of 320 faces' width (40,960 faces) through the
    port's ingest, a batch of one: its planes cross about 640 faces, more
    than the main path's 512 slots, as a CT mesh's neck plane does."""
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.utils import geometry as tgeom

    v, f = synthetic_humerus(n_rings=64, n_theta=320,
                             rng_transform=np.random.default_rng(5))
    nb, wt = stl.edge_face_adjacency(f)
    spec = ingest.spec_from_arrays("long", v, f, nb, wt,
                                   config=tiny_config(max_faces=40960,
                                                      max_verts=24576))
    verts = tgeom.transform_pts(
        torch.as_tensor(spec.vertices, dtype=torch.float32),
        torch.as_tensor(spec.obb_transform, dtype=torch.float32))
    sg = tsl.sorted_geom(*(torch.as_tensor(np.asarray(a))[None] for a in (
        verts, spec.faces, spec.neighbors, spec.face_orig)))
    return sg, float(verts[:, 2].min()), float(verts[:, 2].max())


@pytest.mark.parametrize("select", tsl.SELECTS)
def test_kernel_model_at_the_ct_shape(long_loop_sg, select):
    """k 1024, band 6144, max_chain 1024 (the CT sizes, a block of 1024
    threads on the card) on planes whose loops pass 512 faces: the model's
    loop, points and sums against the plain composition."""
    sg, zlo, zhi = long_loop_sg
    sg = tsl.SortedGeom(*(x.expand((4,) + x.shape[1:]).contiguous()
                          for x in sg))
    z = (zlo + torch.tensor([0.5, 0.7, 0.85, 0.9]) * (zhi - zlo)).float()
    rows = _compaction(sg, z, 6144, 1024)
    assert not bool(tsl._window_starts(sg, z[:, None], 6144)[2].any())
    got = _check_model(rows, 1024, select)
    assert int(got.n.max()) > 512


@pytest.mark.parametrize("select", tsl.SELECTS)
@pytest.mark.parametrize("k", [512, 24])
def test_kernel_model_on_the_tiny_bone(tiny_sg, select, k):
    """Planes through the bone, above and below it and at vertex heights;
    k 24 overflows, breaks chains and sends ranks past the count."""
    sg, zlo, zhi = tiny_sg
    sg = tsl.SortedGeom(*(x.expand((10,) + x.shape[1:]).contiguous()
                          for x in sg))
    z_vert = sg.z_mm[0, ::sg.z_mm.shape[1] // 5, 0][1:4]
    z = torch.cat([torch.tensor([zhi + 5.0, zhi + 1e-3, zlo - 1e-3]),
                   z_vert, zlo + torch.tensor([0.3, 0.55, 0.8, 0.95])
                   * (zhi - zlo)]).to(torch.float32)
    band = min(CFG.full.band, sg.z_key.shape[-1])
    got = _check_model(_compaction(sg, z, band, min(k, band)), CFG.max_chain,
                       select)
    if k == 512:
        assert int((got.n > 10).sum()) >= 5
    else:
        past = torch.arange(CFG.max_chain) >= got.n[:, None]
        assert float(got.points[past].abs().sum()) > 0


def test_label_sums_match_loop_stats(tiny_sg):
    """The exact per-label sums against _loop_stats: counts exactly, area,
    centroid and mean point to rounding."""
    sg, zlo, zhi = tiny_sg
    sg = tsl.SortedGeom(*(x.expand((4,) + x.shape[1:]).contiguous()
                          for x in sg))
    z = (zlo + torch.tensor([0.2, 0.4, 0.6, 0.8]) * (zhi - zlo)).float()
    band = min(CFG.full.band, sg.z_key.shape[-1])
    crossed, start, end, succ, _orig = _compaction(sg, z, band, 48)
    k = succ.shape[1]
    lab = tsl._label_loops(crossed, succ)
    area, centroid, count, mean_pt = tsl._loop_stats(crossed, start, end,
                                                     lab, k)
    sums, counts = label_sums(lab, start, end, k)
    assert torch.equal(counts[:, :k], count[:, :k])
    got_area = 0.5 * sums[:, :k, 0]
    assert float((got_area - area[:, :k]).abs().max()) <= 1e-3
    denom = torch.where(torch.abs(got_area) > 1e-12, 6.0 * got_area, 1.0)
    assert float((sums[:, :k, 1:3] / denom[..., None]
                  - centroid[:, :k]).abs().max()) <= 1e-4
    cnt = torch.clamp(counts[:, :k], min=1).to(sums.dtype)[..., None]
    assert float((sums[:, :k, 3:5] / cnt - mean_pt[:, :k]).abs().max()) \
        <= 1e-4
    assert int(crossed.sum()) > 100


def _triangles(k, loops, clockwise):
    """Compacted rows of triangle loops: loops (lists of 3 slots) with
    their segments around a triangle about (10 i, 0), clockwise or not;
    the other slots uncrossed."""
    crossed = torch.zeros((1, k), dtype=torch.bool)
    start = torch.zeros((1, k, 2))
    end = torch.zeros((1, k, 2))
    succ = torch.arange(k)[None].clone()
    tri = torch.tensor([[0.0, 0.0], [3.0, 0.0], [0.0, 3.0]])
    if clockwise:
        tri = tri.flip(0)
    for i, loop in enumerate(loops):
        for j, slot in enumerate(loop):
            crossed[0, slot] = True
            start[0, slot] = tri[j] + torch.tensor([10.0 * i, 0.0])
            end[0, slot] = tri[(j + 1) % 3] + torch.tensor([10.0 * i, 0.0])
            succ[0, slot] = loop[(j + 1) % 3]
    orig = torch.arange(k)[None].flip(1).to(torch.int32)
    return crossed, start, end, succ, orig


def test_largest_of_holes_only_is_the_first_empty_label():
    """Only clockwise loops (negative areas): largest picks the first
    label without members, at area 0, and gives an empty loop."""
    rows = _triangles(12, [[0, 1, 2], [3, 4, 5]], clockwise=True)
    got = _check_model(rows, 16, "largest")
    assert int(got.n) == 0 and float(got.points.abs().sum()) == 0.0


def test_central_without_a_loop_of_three_takes_label_0():
    """No label has 3 faces: central falls to label 0 (the plain argmin
    over +inf), here a loop of 2."""
    crossed, start, end, succ, orig = _triangles(8, [], clockwise=False)
    crossed[0, :4] = True
    succ[0, :4] = torch.tensor([1, 0, 3, 2])
    start[0, :4] = torch.tensor([[1.0, 0.0], [0.0, 1.0], [5.0, 5.0],
                                 [6.0, 5.0]])
    end[0, :4] = start[0, [1, 0, 3, 2]]
    got = _check_model((crossed, start, end, succ, orig), 8, "central")
    assert int(got.n) == 2


def test_central_picks_the_loop_nearest_the_axis():
    """Two counter-clockwise loops: central takes the one whose mean
    point is nearer the origin, largest the other when it is larger."""
    rows = _triangles(10, [[0, 1, 2], [5, 6, 7]], clockwise=False)
    _, start, end, _, _ = rows
    start[0, 5:8] *= 2.0
    end[0, 5:8] *= 2.0
    _check_model(rows, 8, "central")
    _check_model(rows, 8, "largest")
    _, best_c = raw_kernel_model(*rows, 8, "central")
    _, best_l = raw_kernel_model(*rows, 8, "largest")
    assert int(best_c) == 0 and int(best_l) == 5


def test_cpu_takes_the_plain_composition(tiny_sg, monkeypatch):
    """On CPU tensors the wrapper calls slice_raw_banded_plain (band and
    k clamped) and launches nothing; the kernel path refuses CPU
    tensors."""
    sg, zlo, zhi = tiny_sg
    z = torch.tensor([0.5 * (zlo + zhi)], dtype=torch.float32)
    calls = []
    plain = tsl.slice_raw_banded_plain

    def spy(*args):
        calls.append(args[2:])
        return plain(*args)

    monkeypatch.setattr(tsl, "slice_raw_banded_plain", spy)
    before = trace.counter("launches.slice_raw")
    n_faces = sg.z_key.shape[-1]
    got = tsl.slice_raw_banded(sg, z, 10 ** 6, CFG.max_chain, "central",
                               k=10 ** 6)
    assert calls == [(n_faces, CFG.max_chain, "central", n_faces)]
    assert trace.counter("launches.slice_raw") == before
    assert int(got[0].n[0]) > 10
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsl.slice_raw_kernel(sg, z, 512, CFG.max_chain, "central", 512)


@pytest.mark.parametrize("case", ["z 2-D", "fvt float64", "ids shape",
                                  "not contiguous", "max_chain 0",
                                  "max_chain too large", "select", "k > band",
                                  "band > faces"])
def test_kernel_argument_checks(tiny_sg, case):
    """check_raw_args refuses what the kernel does not take, before any
    launch."""
    sg, zlo, zhi = tiny_sg
    z = torch.tensor([0.5 * (zlo + zhi)], dtype=torch.float32)
    n_faces = sg.z_key.shape[-1]
    args = dict(sg=sg, z=z, band=256, max_chain=CFG.max_chain,
                select="central", k=128)
    err = ValueError
    if case == "z 2-D":
        args["z"] = z[:, None]
    elif case == "fvt float64":
        args["sg"] = sg._replace(fvt=sg.fvt.double())
        err = TypeError
    elif case == "ids shape":
        args["sg"] = sg._replace(ids=sg.ids[..., :3].contiguous())
    elif case == "not contiguous":
        args["sg"] = sg._replace(z_key=sg.z_mm[..., 0])
    elif case == "max_chain 0":
        args["max_chain"] = 0
    elif case == "max_chain too large":
        args["max_chain"] = tsl.RAW_MAX_CHAIN + 1
    elif case == "select":
        args["select"] = "smallest"
    elif case == "k > band":
        args["k"] = 512
    elif case == "band > faces":
        args["band"] = args["k"] = n_faces + 1
    with pytest.raises(err):
        tsl.check_raw_args(**args)
    with pytest.raises(err):
        tsl.slice_raw_kernel(*args.values())


def test_kernel_argument_checks_pass(tiny_sg):
    sg, zlo, zhi = tiny_sg
    z = torch.tensor([0.5 * (zlo + zhi)], dtype=torch.float32)
    tsl.check_raw_args(sg, z, 256, CFG.max_chain, "largest", 128)
