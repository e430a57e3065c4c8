"""Batched mesh x plane cross-sections (PyTorch), walk path.

Port of shoulder_tpu/ops/slicing.py.  What the landmark pipeline runs:

  1. `sorted_geom` on faces presorted by z_min at ingest,
  2. per-plane windows of the z-sorted faces (`_window_starts`),
  3. per-plane compaction of the crossed faces and their oriented
     intersection segments (`_compact_slice`),
  4. the contour-chain walk over the compacted successor map
     (ops/chain_walk.py's plain walk),
  5. largest-loop selection and arc-length resampling (`_post_walk`,
     `_resample`),

plus the single-plane raw loop of the surgical neck (`slice_raw_banded`:
pointer doubling, as in the JAX package on every backend; on the card one
launch of csrc/slice_raw.cu for the batch, on the CPU its plain
composition `slice_raw_banded_plain`).  Beside it,
off the pipeline's path: `sorted_geom` without `face_orig` (the device
sort by (z_min, face id)), the full-set single-plane section `slice_raw`
on `FaceGeom` (`_crossing_topology`, `_segment_points`), and the section
points of an arbitrarily oriented plane (`plane_section_points`).  The
JAX package's doubling branch of `slice_stack` and its `_slice_one` are
bit-identical to the walk there and have no counterpart here.

`slice_stack` runs steps 2-5 for a whole stack of a whole bone batch.
On the card it is one launch of the fused kernel csrc/slice_stack.cu
(`slice_stack_kernel`, one block per (bone, plane), everything between
the steps in shared memory); on the CPU it is their plain PyTorch
composition (`slice_stack_plain`), which is the kernel's plain version.

JAX's per-slice `vmap` is an explicit slice dimension (..., S, ...) here,
and its per-bone `vmap` a leading bone dimension: a SortedGeom of a batch
has fields (B, F, ...) and its planes are zs (B, S); one bone's has
fields (F, ...) and planes (S,).  Per-plane work runs on the B·S planes
as rows, each reading its own bone's faces.  Orientation is combinatorial (the sign pattern of the vertex
heights), never a dot product: a plane that grazes a vertex gives a
near-zero segment whose dot-product sign is noise.  Segments are directed
z_hat x face_normal, so exterior loops come out CCW (positive area).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shoulder_tpu_torch.ops import chain_walk, kernels
from shoulder_tpu_torch.ops import signal
from shoulder_tpu_torch.pipeline import graphs
from shoulder_tpu_torch.utils import trace

_BIG = torch.iinfo(torch.int32).max
# the slice-stack kernel's limits: its block takes 64 k + 2 band + 20 bytes
# of shared memory (csrc/slice_stack.cu), 160 KB here, under the card's
# 227 KB per block
KERNEL_MAX_K = 2048
KERNEL_MAX_BAND = 16384
KERNEL_MAX_BONES = 65535  # the launch's grid y dimension: one bone each
# the raw-loop kernel (csrc/slice_raw.cu) takes k and band as the
# slice-stack kernel does and max_chain output points; its block takes
# 84 k + 4 max_chain + 2 band bytes (csrc/slice_raw.cu), and a launch
# whose block would pass the card's 227 KB is refused (the wrapper raises)
RAW_MAX_CHAIN = 8192
SELECTS = ("largest", "central")
STAGES = ("window", "compaction", "segments", "injectivity", "walk",
          "moments", "roll", "knots", "resample")  # timed kernel's stages
# the raw-loop kernel's timed stages: its nine, the per-label sums in their
# two halves (the counts, then the sums), and the output write
RAW_STAGES = ("window", "compaction", "segments", "injectivity", "labels",
              "counts", "sums", "pick", "min_orig", "ranks", "write")


class SliceStack(NamedTuple):
    """One stack's sections; a batch's carry a leading bone dim (B, S, ...)."""

    contours: torch.Tensor     # (S, N, 2) resampled largest-loop contours
    centroids: torch.Tensor    # (S, 2) area centroid of the largest loop
    areas: torch.Tensor        # (S,) largest-loop signed area
    total_areas: torch.Tensor  # (S,) sum of signed loop areas
    zs: torch.Tensor           # (S,)
    overflow: torch.Tensor     # (S,) bool: band or compaction missed a face
    open_edges: torch.Tensor   # (S,) bool: a chain dead-ended at an open edge


class RawLoop(NamedTuple):
    """One plane's raw loop; a batch's carry a leading bone dim (B, ...)."""

    points: torch.Tensor    # (max_chain, 2) ordered loop points (padded)
    n: torch.Tensor         # () number of valid points
    area: torch.Tensor      # ()
    centroid: torch.Tensor  # (2,)


class FaceGeom(NamedTuple):
    """Each face's vertex coordinates and neighbours, in the mesh's own
    face order; a bone batch stacks them on a leading dim (B, F, 3)."""

    fvx: torch.Tensor        # (F, 3) x of the face's 3 vertices
    fvy: torch.Tensor        # (F, 3)
    fvz: torch.Tensor        # (F, 3)
    neighbors: torch.Tensor  # (F, 3) neighbour face across edge slot j


def face_geom(verts, faces, neighbors) -> FaceGeom:
    """FaceGeom of verts (..., V, 3), faces and neighbors (..., F, 3)."""
    lead, n_faces = faces.shape[:-2], faces.shape[-2]
    idx = faces.long().reshape(lead + (n_faces * 3, 1)).expand(
        lead + (n_faces * 3, 3))
    fv = verts.gather(-2, idx).reshape(lead + (n_faces, 3, 3))
    return FaceGeom(fv[..., 0], fv[..., 1], fv[..., 2], neighbors)


class SortedGeom(NamedTuple):
    """Face geometry in z_min order, for banded slicing.

    A plane at height z only crosses faces in a short window of the sorted
    order, so per-plane work runs on a (band,) window of it.  Padding
    faces carry z_min = +inf and z_max = -inf, so they never cross.  A
    bone batch stacks the fields on a leading dim (B, F, ...).
    """

    fvt: torch.Tensor       # (F, 9) f32 per face: x0 x1 x2 y0 y1 y2 z0 z1 z2
    ids: torch.Tensor       # (F, 4) int32 per face: original id, 3 neighbor
    #                         ids in the sorted frame (-1 none)
    z_key: torch.Tensor     # (F,) non-decreasing search key, <= z_min slotwise
    z_mm: torch.Tensor      # (F, 2) [z_min, z_max] per slot
    cummax_z_max: torch.Tensor  # (F,) running max of z_max


def _z_range(g: FaceGeom, faces):
    """(z_min, z_max) per face; degenerate (padding) faces get +inf and
    -inf, so they sort past every window and never cross."""
    degenerate = ((faces[..., 0] == faces[..., 1])
                  & (faces[..., 1] == faces[..., 2]))
    return (torch.where(degenerate, torch.inf, g.fvz.amin(dim=-1)),
            torch.where(degenerate, -torch.inf, g.fvz.amax(dim=-1)))


@graphs.graphed
def sorted_geom(verts, faces, neighbors, face_orig=None) -> SortedGeom:
    """Z-sorted face geometry of verts (..., V, 3), faces and neighbors
    (..., F, 3); leading dims are a bone batch, each bone sorted and
    scanned along its own face axis.

    With `face_orig` the faces are presorted by z_min at ingest and
    `face_orig[i]` is slot i's original face index (loop starts use the
    smallest original index).  Host and device transforms can disagree by
    ulps near z-ties, so the window search key is then a suffix running
    min of z_min rather than z_min itself: every face with z_min <= z
    stays below the key's insertion point of z.

    Without it the faces are sorted here, by (z_min, face id): a stable
    sort on z_min, which orders equal z_min (the padding faces' +inf
    among them) by face id as JAX's two-key `lax.sort` does, so a batch
    sorts each bone as that bone alone.  Neighbours are renumbered into
    the sorted frame, and the sorted geometry is then a presorted one
    with `face_orig` the sort's order (the suffix min of sorted keys is
    the keys themselves).
    """
    g = face_geom(verts, faces, neighbors)
    if face_orig is None:
        z_min, _ = _z_range(g, faces)
        order = torch.sort(z_min, dim=-1, stable=True).indices
        inv = torch.empty_like(order).scatter_(
            -1, order, torch.arange(order.shape[-1], device=order.device)
            .expand_as(order).contiguous())
        nbr = neighbors.long()
        nbr = torch.where(nbr >= 0, inv.gather(-1, torch.clamp(
            nbr, min=0).flatten(-2)).reshape(nbr.shape), -1)
        pick = order[..., None].expand(order.shape + (3,))
        return sorted_geom(verts, faces.gather(-2, pick), nbr.gather(-2, pick),
                           order)
    z_min, z_max = _z_range(g, faces)
    z_key = torch.flip(torch.cummin(torch.flip(z_min, [-1]), dim=-1).values,
                       [-1])
    ids = torch.cat([face_orig.to(torch.int32)[..., None],
                     neighbors.to(torch.int32)], dim=-1)
    return SortedGeom(
        fvt=torch.cat([g.fvx, g.fvy, g.fvz], dim=-1),
        ids=ids,
        z_key=z_key,
        z_mm=torch.stack([z_min, z_max], dim=-1),
        cummax_z_max=torch.cummax(z_max, dim=-1).values,
    )


def _flat(sg: SortedGeom):
    """(one SortedGeom of all a batch's faces, the first row of each bone
    (B,)): bone b's slot i is row b * F + i of the flat table."""
    n_faces = sg.z_key.shape[-1]
    flat = SortedGeom(*(x.reshape((-1,) + x.shape[sg.z_key.dim():])
                        for x in sg))
    base = torch.arange(sg.z_key.numel() // n_faces,
                        device=sg.z_key.device) * n_faces
    return flat, base


def _window_starts(sg: SortedGeom, zs, band: int):
    """Window offsets, insertion points and overflow flags of planes `zs`
    (..., S) of the bones of `sg` (..., F).

    Window s is slots [lo[s], lo[s] + band) of the sorted order, ending
    at the insertion point of zs[s].  Overflow: a face below the window
    still reaches the plane (the band is too small for it).
    """
    n_faces = sg.z_key.shape[-1]
    starts = torch.searchsorted(sg.z_key, zs, side="left")
    lo = torch.clamp(starts - band, 0, n_faces - band)
    below = torch.clamp(lo - 1, min=0)
    overflow = (lo > 0) & (sg.cummax_z_max.gather(-1, below) >= zs)
    return lo, starts, overflow


def _compact_slice(sg: SortedGeom, zmm_w, lo, z, k: int, base=0):
    """Crossed faces of S planes compacted to the first k slots of a row.

    zmm_w (S, band, 2) are the planes' [z_min, z_max] windows starting at
    slot lo (S,) of their bone, whose slot 0 is row `base` (S,) of `sg`'s
    face table (0 for one bone; `_flat` for a batch).  A face crosses
    plane z iff z_min < z <= z_max (with the d == 0 -> +1e-7 convention
    of the segment math).  Crossed faces keep their window order in slots
    [0, ncross); slots past ncross are invalid.  Returns, per row:
    crossed (S,k) bool, start and end (S,k,2) segment endpoints, succ
    (S,k) compact successor (self where none), orig (S,k) original face
    ids, overflow (S,) (more than k crossed), open_edge (S,) (a crossed
    face has no crossed neighbor across its exit edge).
    """
    n_rows, band = zmm_w.shape[0], zmm_w.shape[1]
    dev = zmm_w.device
    z = z[:, None]
    crossed = (zmm_w[:, :, 1] >= z) & (zmm_w[:, :, 0] < z)
    csum = torch.cumsum(crossed, dim=1)                   # int64
    ncross = csum[:, -1]
    over = ncross > k
    rows = torch.arange(k, device=dev)
    # order[j] = window position of the j-th crossed face
    # a copy whatever n_rows is (contiguous() would copy only for n_rows > 1)
    targets = (rows + 1).expand(n_rows, k).clone()
    order = torch.searchsorted(csum, targets, side="left")
    order = torch.clamp(order, max=band - 1)
    valid = rows < ncross[:, None]
    slot = (lo + base)[:, None] + order                   # (S, k)
    g = sg.fvt[slot]                                      # (S, k, 9)
    gi = sg.ids[slot]                                     # (S, k, 4)
    gx, gy, gz = g[..., 0:3], g[..., 3:6], g[..., 6:9]
    d = gz - z[..., None]
    d = torch.where(d == 0.0, 1e-7, d)
    pos = d > 0.0
    pos_n = torch.roll(pos, -1, dims=2)
    crossed_c = ((pos != pos_n).sum(dim=2) == 2) & valid
    entry = torch.argmax((pos & ~pos_n).to(torch.int8), dim=2, keepdim=True)
    exit_ = torch.argmax((~pos & pos_n).to(torch.int8), dim=2, keepdim=True)
    denom = d - torch.roll(d, -1, dims=2)
    denom = torch.where(torch.abs(denom) < 1e-30, 1.0, denom)
    t = d / denom
    px = gx + t * (torch.roll(gx, -1, dims=2) - gx)       # (S, k, 3)
    py = gy + t * (torch.roll(gy, -1, dims=2) - gy)
    start = torch.cat([px.gather(2, entry), py.gather(2, entry)], dim=2)
    end = torch.cat([px.gather(2, exit_), py.gather(2, exit_)], dim=2)

    # successor: the neighbor across the exit edge, as a compact slot.
    # Valid slots hold distinct window positions, so an inverse map from
    # window position to compact slot finds it (column `band` is a dump).
    nbr_exit = gi[..., 1:4].gather(2, exit_)[..., 0].to(torch.int64)
    succ_w = torch.where(nbr_exit >= 0, nbr_exit - lo[:, None], -1)
    in_win = (succ_w >= 0) & (succ_w < band)
    inv = torch.full((n_rows, band + 1), -1, dtype=torch.int64, device=dev)
    inv.scatter_(1, torch.where(valid, order, band), rows.expand(n_rows, k))
    inv[:, band] = -1
    succ_idx = inv.gather(1, torch.where(in_win, succ_w, band))
    has = succ_idx >= 0
    open_edge = crossed_c & ~has
    # injectivity: when a plane grazes a vertex, two faces can claim one
    # successor; keep the smallest-slot predecessor and dead-end the rest
    linked = crossed_c & has
    tgt = torch.where(linked, succ_idx, k)
    first_pred = torch.full((n_rows, k + 1), k, dtype=torch.int64, device=dev)
    first_pred.scatter_reduce_(1, tgt, rows.expand(n_rows, k), reduce="amin")
    keep = linked & (first_pred.gather(1, tgt) == rows)
    succ = torch.where(keep, succ_idx, rows)
    open_any = (open_edge & ~over[:, None]).any(dim=1)
    return crossed_c, start, end, succ, gi[..., 0], over, open_any


def _resample(points, n_valid, interp_num: int):
    """Arc-length resample of S padded ordered loops, closing each first.

    points (S, M, 2), n_valid (S,) -> (S, interp_num, 2).
    """
    n_rows, m = points.shape[0], points.shape[1]
    dev, dt = points.device, points.dtype
    idx = torch.arange(m + 1, device=dev)
    nv = n_valid[:, None]
    first = points[:, :1]
    closed = torch.cat([points, first], dim=1)
    # position n_valid holds the closing point; beyond it, repeat it so
    # padded entries never influence the interpolation
    closed = torch.where((idx[None, :] < nv)[..., None], closed, first)
    seg = torch.linalg.vector_norm(torch.diff(closed, dim=1), dim=2)
    seg = torch.where(idx[None, :-1] < nv, seg, 0.0)
    cum = torch.cat([torch.zeros((n_rows, 1), dtype=dt, device=dev),
                     torch.cumsum(seg, dim=1)], dim=1)
    total = cum[:, -1:]
    # strictly increase past the valid range so sampling never lands there
    cum = torch.where(idx[None, :] <= nv, cum, total + (idx[None, :] - nv).to(dt))

    step = total / (interp_num - 1)
    step = torch.where(step > 0, step, 1.0)
    first_sample = torch.ceil(cum / step).to(torch.int64)
    d = torch.arange(interp_num, dtype=dt, device=dev)[None, :] * step
    # sample j interpolates the segment of knot max{i : first_sample[i] <= j}
    table = torch.cat([closed, cum[..., None]], dim=2)          # (S, M+1, 3)
    pair = torch.cat([table, torch.cat([table[:, 1:], table[:, -1:]], dim=1)],
                     dim=2)                                     # (S, M+1, 6)
    g = signal.fill_from_scatter(first_sample, pair, interp_num, pair[:, 0])
    g0, g1 = g[..., 0:3], g[..., 3:6]
    c0, c1 = g0[..., 2], g1[..., 2]
    t = torch.clamp((d - c0) / torch.where(c1 > c0, c1 - c0, 1.0), 0.0, 1.0)
    p0, p1 = g0[..., 0:2], g1[..., 0:2]
    return p0 + t[..., None] * (p1 - p0)


def _post_walk(order, is_start, n, start, end, orig, interp_num: int):
    """Finish S slices from the walk: pick the largest loop, roll it to
    its smallest original face id, and resample it.

    The walk emits each loop as a contiguous run of positions, so per-loop
    moments are differences of one prefix sum.  Returns (contour
    (S, interp_num, 2), centroid (S, 2), area (S,), total area (S,)).
    """
    n_rows, kk = order.shape
    dev, dt = start.device, start.dtype
    posn = torch.arange(kk, device=dev)
    n = n[:, None].to(torch.int64)
    valid = posn < n
    f = torch.where(valid, order.to(torch.int64), 0)
    f2 = f[..., None].expand(n_rows, kk, 2)
    s_w = start.gather(1, f2)                       # walk order
    e_w = end.gather(1, f2)
    o_w = orig.to(torch.int64).gather(1, f)
    sx, sy, ex, ey = s_w[..., 0], s_w[..., 1], e_w[..., 0], e_w[..., 1]
    cr2 = torch.where(valid, sx * ey - ex * sy, 0.0)
    run_start = valid & is_start
    # a run ends just before the next start, or at the last valid position
    run_end = valid & (torch.roll(run_start, -1, dims=1) | (posn == n - 1))

    contrib = torch.stack([cr2, (sx + ex) * cr2, (sy + ey) * cr2], dim=2)
    cum = torch.cumsum(contrib, dim=1)                          # (S, K, 3)
    sor = torch.cummax(torch.where(run_start, posn, -1), dim=1).values
    cum_pad = torch.cat([torch.zeros((n_rows, 1, 3), dtype=dt, device=dev),
                         cum], dim=1)
    before = cum_pad.gather(1, torch.clamp(sor, min=0)[..., None].expand(-1, -1, 3))
    run = cum - before                          # run-local prefix moments
    area_run = 0.5 * run[..., 0]

    # best loop = max signed area over run ends; holes-only slices keep an
    # empty contour
    e = torch.argmax(torch.where(run_end, area_run, -torch.inf), dim=1,
                     keepdim=True)
    has = run_end.gather(1, e) & (area_run.gather(1, e) >= 0.0)
    area_best = torch.where(has, area_run.gather(1, e), 0.0)
    denom = torch.where(torch.abs(area_best) > 1e-12, 6.0 * area_best, 1.0)
    run_e = run.gather(1, e[..., None].expand(-1, -1, 3))[:, 0, 1:3]
    centroid = torch.where(has, run_e / denom, 0.0)
    sor_e = sor.gather(1, e)
    n_best = torch.where(has, e - sor_e + 1, 0)
    p0 = torch.where(has, sor_e, 0)
    nb = torch.clamp(n_best, min=1)
    # the loop starts at its member with the smallest original face id:
    # a roll of the contiguous span [p0, p0 + n_best)
    in_span = (posn >= p0) & (posn < p0 + n_best)
    og = torch.where(in_span, o_w, _BIG)
    off = torch.argmin(og, dim=1, keepdim=True) - p0
    ring = p0 + torch.remainder(posn + off, nb)
    pts = s_w.gather(1, torch.clamp(ring, max=kk - 1)[..., None].expand(-1, -1, 2))
    pts = torch.where((posn < n_best)[..., None], pts, 0.0)
    contour = _resample(pts, n_best[:, 0], interp_num)
    return contour, centroid, area_best[:, 0], 0.5 * cr2.sum(dim=1)


@graphs.graphed
def slice_stack(sg: SortedGeom, zs, interp_num: int, band: int,
                compact_k: int = 512, chunk: int = 150) -> SliceStack:
    """Cross-section contour stacks of planes zs (B, S) of a bone batch
    (or (S,) of one bone).

    CPU tensors take the plain composition (`slice_stack_plain`); CUDA
    tensors launch the fused kernel once for all B·S planes, or raise.
    `chunk` bounds the plain version's intermediates; the kernel has none.
    """
    band = min(band, sg.z_key.shape[-1])
    k = min(compact_k, band)
    if zs.device.type == "cpu":
        return slice_stack_plain(sg, zs, interp_num, band, k, chunk)
    return slice_stack_kernel(sg, zs.contiguous(), interp_num, band, k)


def compact_stack(sg: SortedGeom, zs, band: int, k: int, chunk: int = 150):
    """`_compact_slice` over all planes zs (..., S) of the bones of `sg`,
    `chunk` planes of the B·S at a time (it bounds the (chunk, band) and
    (chunk, k, 9) intermediates).  Returns its outputs with zs's leading
    shape (..., S, k, ...), `over` including window overflow."""
    los, _starts, win_over = _window_starts(sg, zs, band)
    flat, base = _flat(sg)
    n_planes = zs.shape[-1]
    base = base[:, None].expand(-1, n_planes).reshape(-1)
    los, zs_rows = los.reshape(-1), zs.reshape(-1)
    win = torch.arange(band, device=zs.device)
    parts = []
    for c0 in range(0, zs_rows.shape[0], chunk):
        lo, b = los[c0:c0 + chunk], base[c0:c0 + chunk]
        zmm_w = flat.z_mm[(b + lo)[:, None] + win]          # (c, band, 2)
        parts.append(_compact_slice(flat, zmm_w, lo, zs_rows[c0:c0 + chunk],
                                    k, b))
    crossed, start, end, succ, orig, over, open_edges = (
        torch.cat(x, dim=0).reshape(zs.shape + x[0].shape[1:])
        for x in zip(*parts)
    )
    return crossed, start, end, succ, orig, win_over | over, open_edges


def slice_stack_plain(sg: SortedGeom, zs, interp_num: int, band: int,
                      k: int, chunk: int = 150) -> SliceStack:
    """The plain composition behind `slice_stack` (band and k already
    clamped): compaction, one plain walk over all B·S planes, loop
    finish."""
    crossed, start, end, succ, orig, overflow, open_edges = compact_stack(
        sg, zs, band, k, chunk)
    rows = zs.numel()
    order, n, is_start = chain_walk.chain_walk_plain(
        succ.reshape(rows, k).to(torch.int32).contiguous(),
        crossed.reshape(rows, k).to(torch.int32).contiguous()
    )
    contours, centroids, areas, total_areas = _post_walk(
        order, is_start, n, start.reshape(rows, k, 2),
        end.reshape(rows, k, 2), orig.reshape(rows, k), interp_num
    )
    return SliceStack(contours.reshape(zs.shape + contours.shape[1:]),
                      centroids.reshape(zs.shape + (2,)),
                      areas.reshape(zs.shape), total_areas.reshape(zs.shape),
                      zs, overflow, open_edges)


def check_kernel_args(sg: SortedGeom, zs, interp_num: int, band: int,
                      k: int) -> None:
    """Raise unless the slice-stack kernel takes these arguments: dtypes,
    shapes (planes zs (B, S) of B bones, or (S,) of one), contiguity,
    alignment, one device, and band / k / interp_num within the kernel's
    limits.  Reads metadata only."""
    if zs.dim() not in (1, 2):
        raise ValueError(f"zs must be (B, S) or (S,), not {tuple(zs.shape)}")
    lead = tuple(zs.shape[:-1])
    n_faces = sg.z_key.shape[-1]
    f32, i32 = torch.float32, torch.int32
    want = {"fvt": (sg.fvt, f32, lead + (n_faces, 9)),
            "ids": (sg.ids, i32, lead + (n_faces, 4)),
            "z_mm": (sg.z_mm, f32, lead + (n_faces, 2)),
            "z_key": (sg.z_key, f32, lead + (n_faces,)),
            "cummax_z_max": (sg.cummax_z_max, f32, lead + (n_faces,)),
            "zs": (zs, f32, tuple(zs.shape))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernel "
                             f"takes {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != zs.device:
            raise ValueError(f"{name} is on {t.device}, zs on {zs.device}")
    if sg.ids.data_ptr() % 16 or sg.z_mm.data_ptr() % 8:
        raise ValueError("ids must be 16-byte and z_mm 8-byte aligned")
    if not 1 <= k <= min(band, KERNEL_MAX_K):
        raise ValueError(f"k {k} outside the kernel's [1, min(band {band}, "
                         f"{KERNEL_MAX_K})]")
    if not band <= min(n_faces, KERNEL_MAX_BAND):
        raise ValueError(f"band {band} above min(faces {n_faces}, "
                         f"{KERNEL_MAX_BAND})")
    if interp_num < 2:
        raise ValueError(f"interp_num {interp_num} below 2")
    if lead and lead[0] > KERNEL_MAX_BONES:
        raise ValueError(f"{lead[0]} bones above the kernel's "
                         f"{KERNEL_MAX_BONES}")


def _check_out(name, t, dtype, shape, zs):
    if (t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.device != zs.device):
        raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                         f"tensor beside zs")


def slice_stack_kernel(sg: SortedGeom, zs, interp_num: int, band: int,
                       k: int, stamps=None, walk=None) -> SliceStack:
    """One launch of csrc/slice_stack.cu over all planes zs (B, S) of a
    bone batch (or (S,) of one bone; CUDA tensors; band and k already
    clamped).  Raises on arguments the kernel does not take, on a failed
    build and on a refused launch.

    With `stamps`, a (B·S, 12) int64 tensor, or `walk`, a pair of int32
    tensors (B·S, k) and (B·S,), it launches the kernel's timed build,
    which writes each block's stage clocks into `stamps` (`stage_times`)
    and each block's walk into `walk`: the face at each walk position,
    +k where a loop starts, -1 at and past n, and n."""
    check_kernel_args(sg, zs, interp_num, band, k)
    rows = zs.numel()
    if stamps is not None:
        _check_out("stamps", stamps, torch.int64, (rows, 12), zs)
    if walk is not None:
        _check_out("walk[0]", walk[0], torch.int32, (rows, k), zs)
        _check_out("walk[1]", walk[1], torch.int32, (rows,), zs)
    if zs.device.type != "cuda":
        raise ValueError(f"the slice-stack kernel runs on CUDA tensors, not "
                         f"{zs.device}")
    lib = kernels.library()
    n_bones = zs.shape[0] if zs.dim() == 2 else 1
    n_planes, dev = zs.shape[-1], zs.device
    f32 = dict(dtype=torch.float32, device=dev)
    contours = torch.empty(zs.shape + (interp_num, 2), **f32)
    centroids = torch.empty(zs.shape + (2,), **f32)
    areas = torch.empty(zs.shape, **f32)
    total_areas = torch.empty(zs.shape, **f32)
    overflow = torch.empty(zs.shape, dtype=torch.bool, device=dev)
    open_edges = torch.empty(zs.shape, dtype=torch.bool, device=dev)
    outs = [contours.data_ptr(), centroids.data_ptr(), areas.data_ptr(),
            total_areas.data_ptr(), overflow.data_ptr(),
            open_edges.data_ptr()]
    launcher = lib.slice_stack_launch
    if stamps is not None or walk is not None:
        launcher = lib.slice_stack_launch_timed
        outs += [None if stamps is None else stamps.data_ptr(),
                 *((None, None) if walk is None
                   else (walk[0].data_ptr(), walk[1].data_ptr()))]
    rc = launcher(
        sg.fvt.data_ptr(), sg.ids.data_ptr(), sg.z_mm.data_ptr(),
        sg.z_key.data_ptr(), sg.cummax_z_max.data_ptr(), zs.data_ptr(),
        *outs, sg.z_key.shape[-1], n_bones, n_planes, band, k, interp_num,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"slice_stack kernel launch failed: CUDA error {rc}")
    if zs.numel():  # no planes, no launch
        trace.count("launches.slice_stack")
    return SliceStack(contours, centroids, areas, total_areas, zs, overflow,
                      open_edges)


def stage_times(stamps):
    """(us, ghz) from a timed launch's stamps (rows of clock64 at the
    start and after each of n stages, then %globaltimer at the start and
    the end): each block's time in each stage (rows, n) in microseconds
    (`STAGES` of the slice-stack kernel, `RAW_STAGES` of the raw loop's),
    and the SM clock in GHz, taken as the blocks' cycles over their
    %globaltimer nanoseconds."""
    s = stamps.cpu().double()
    n = s.shape[1] - 3
    ghz = float((s[:, n] - s[:, 0]).sum() / (s[:, n + 2] - s[:, n + 1]).sum())
    return (s[:, 1:n + 1] - s[:, 0:n]) / (ghz * 1e3), ghz


def compact_points(points, mask, out_n: int):
    """Pack masked rows to the front of each set, points (..., N, D) and
    mask (..., N): (packed (..., out_n, D), count (...,)); rows past count
    are zeros."""
    order = torch.argsort((~mask).to(torch.int8), dim=-1,
                          stable=True)[..., :out_n]
    packed = points.gather(-2, order[..., None].expand(
        order.shape + points.shape[-1:]))
    keep = mask.gather(-1, order)
    packed = torch.where(keep[..., None], packed, 0.0)
    return packed, torch.clamp(mask.sum(dim=-1), max=out_n)


def _iters_for(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _label_loops(crossed, succ):
    """Min-index loop labels of each row (B, k) via pointer doubling;
    uncrossed -> k."""
    k = succ.shape[-1]
    lab = torch.where(crossed, torch.arange(k, device=succ.device), k)
    ptr = succ
    for _ in range(_iters_for(k)):
        lab = torch.minimum(lab, torch.where(crossed, lab.gather(-1, ptr),
                                             lab))
        ptr = ptr.gather(-1, ptr)
    return lab


def _loop_stats(crossed, start, end, lab, k: int):
    """Per-label signed area, area centroid, point count and mean point of
    each row (B, k), summed into k+1 slots (slot k collects the uncrossed
    faces).  The sums are reductions over a (B, k, k+1) label mask, not
    float atomics, so they come out the same in every run."""
    dt, dev = start.dtype, start.device
    in_slot = lab[..., :, None] == torch.arange(k + 1, device=dev)

    def seg_sum(v):
        return torch.where(in_slot, v[..., :, None], 0).sum(dim=-2)

    sx0, sy0, ex0, ey0 = start[..., 0], start[..., 1], end[..., 0], end[..., 1]
    cross2 = torch.where(crossed, sx0 * ey0 - ex0 * sy0, 0.0)
    area = 0.5 * seg_sum(cross2)
    cx = seg_sum((sx0 + ex0) * cross2)
    cy = seg_sum((sy0 + ey0) * cross2)
    denom = torch.where(torch.abs(area) > 1e-12, 6.0 * area, 1.0)
    centroid = torch.stack([cx, cy], dim=-1) / denom[..., None]
    count = seg_sum(crossed.to(torch.int64))
    sx = seg_sum(torch.where(crossed, sx0, 0.0))
    sy = seg_sum(torch.where(crossed, sy0, 0.0))
    cnt = torch.clamp(count, min=1).to(dt)
    mean_pt = torch.stack([sx, sy], dim=-1) / cnt[..., None]
    return area, centroid, count, mean_pt


def _order_loop(crossed, start, succ, lab, best, count_best, max_chain: int,
                is_rep, iters: int | None = None):
    """Ordered (B, max_chain, 2) points of each row's loop labelled
    best (B,), starting at its face marked `is_rep`, by pointer-jumping
    list ranking in `iters` rounds (log2 of the row length by default).
    A chain that dead-ends keeps doubling its rank every round, so where
    a row stands for a longer face set the caller passes that set's
    count, as the JAX package ranks it."""
    k = succ.shape[-1]
    rows = torch.arange(k, device=succ.device)
    member = crossed & (lab == best[:, None])
    ptr = torch.where(is_rep, rows, succ)
    rnk = torch.where(is_rep, 0, 1)
    for _ in range(_iters_for(k) if iters is None else iters):
        rnk = rnk + rnk.gather(-1, ptr)
        ptr = ptr.gather(-1, ptr)
    position = torch.where(is_rep, 0, count_best[:, None] - rnk)
    # a chain cut by an overflow never reaches the start face, so its rank
    # runs past the count: the JAX package's scatter (`.at[].set`, mode
    # "drop") wraps such a negative position once from the end and drops
    # what lies outside [0, max_chain); so do we
    position = torch.where(position < 0, position + max_chain, position)
    position = torch.where(member & (position >= 0) & (position < max_chain),
                           position, max_chain)
    # where such positions collide, the largest slot wins, as a sequential
    # scatter in slot order leaves it; an integer amax says so on every
    # device
    owner = torch.full((succ.shape[0], max_chain + 1), -1, dtype=torch.int64,
                       device=succ.device)
    owner.scatter_reduce_(1, position, rows.expand_as(position),
                          reduce="amax")
    owner = owner[:, :max_chain]
    points = start.gather(1, owner.clamp(min=0)[..., None].expand(
        owner.shape + (2,)))
    return torch.where((owner >= 0)[..., None], points, 0.0)


def slice_raw_banded(sg: SortedGeom, z, band: int, max_chain: int = 2048,
                     select: str = "largest", k: int = 512):
    """Single-plane raw loop (ordered, not resampled) on a banded window,
    one plane z (B,) per bone of the batched `sg`.

    select='largest' picks the max-area loop; select='central' the loop
    (of at least 3 faces) whose mean point is nearest the z axis.  The
    loop starts at its smallest original face id.  Returns (RawLoop,
    overflow), each with a leading (B,).  No host read.

    CPU tensors take the plain composition (`slice_raw_banded_plain`);
    CUDA tensors launch csrc/slice_raw.cu once for the batch
    (`slice_raw_kernel`), or raise.
    """
    band = min(band, sg.z_key.shape[-1])
    k = min(k, band)
    if z.device.type == "cpu":
        return slice_raw_banded_plain(sg, z, band, max_chain, select, k)
    return slice_raw_kernel(sg, z.contiguous(), band, max_chain, select, k)


def check_raw_args(sg: SortedGeom, z, band: int, max_chain: int,
                   select: str, k: int) -> None:
    """Raise unless the raw-loop kernel takes these arguments: the
    slice-stack kernel's checks on (sg, z[:, None]) (dtypes, shapes,
    contiguity, alignment, one device, band and k), z of shape (B,),
    max_chain and select.  Reads metadata only."""
    if z.dim() != 1:
        raise ValueError(f"z must be (B,), one plane per bone, not "
                         f"{tuple(z.shape)}")
    check_kernel_args(sg, z[:, None], 2, band, k)
    if not 1 <= max_chain <= RAW_MAX_CHAIN:
        raise ValueError(f"max_chain {max_chain} outside the kernel's "
                         f"[1, {RAW_MAX_CHAIN}]")
    if select not in SELECTS:
        raise ValueError(select)


def slice_raw_kernel(sg: SortedGeom, z, band: int, max_chain: int,
                     select: str, k: int, stamps=None, lib=None):
    """One launch of csrc/slice_raw.cu over the planes z (B,) of a bone
    batch (CUDA tensors; band and k already clamped): what
    `slice_raw_banded_plain` returns.  Raises on arguments the kernel does
    not take, on a failed build and on a refused launch.

    With `stamps`, a (B, len(RAW_STAGES) + 3) int64 tensor, it launches the
    kernel's timed build, which writes each block's stage clocks there
    (`stage_times`).  `lib`: another build of the same entry points
    (measurement only; the package's own library by default)."""
    check_raw_args(sg, z, band, max_chain, select, k)
    if stamps is not None:
        _check_out("stamps", stamps, torch.int64,
                   (z.shape[0], len(RAW_STAGES) + 3), z)
    if z.device.type != "cuda":
        raise ValueError(f"the raw-loop kernel runs on CUDA tensors, not "
                         f"{z.device}")
    lib = lib or kernels.library()
    n_bones, dev = z.shape[0], z.device
    f32 = dict(dtype=torch.float32, device=dev)
    points = torch.empty((n_bones, max_chain, 2), **f32)
    n = torch.empty((n_bones,), dtype=torch.int64, device=dev)
    area = torch.empty((n_bones,), **f32)
    centroid = torch.empty((n_bones, 2), **f32)
    overflow = torch.empty((n_bones,), dtype=torch.bool, device=dev)
    outs = [points.data_ptr(), n.data_ptr(), area.data_ptr(),
            centroid.data_ptr(), overflow.data_ptr()]
    launcher = lib.slice_raw_launch
    if stamps is not None:
        launcher = lib.slice_raw_launch_timed
        outs.append(stamps.data_ptr())
    rc = launcher(
        sg.fvt.data_ptr(), sg.ids.data_ptr(), sg.z_mm.data_ptr(),
        sg.z_key.data_ptr(), sg.cummax_z_max.data_ptr(), z.data_ptr(),
        *outs, sg.z_key.shape[-1], n_bones, band, k, max_chain,
        SELECTS.index(select), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"slice_raw kernel launch failed: CUDA error {rc}")
    if n_bones:  # no bones, no launch
        trace.count("launches.slice_raw")
    return RawLoop(points, n, area, centroid), overflow


def slice_raw_banded_plain(sg: SortedGeom, z, band: int, max_chain: int,
                           select: str, k: int):
    """The plain composition behind `slice_raw_banded` (band and k
    already clamped): window, compaction, labels, per-label sums, the
    pick, the loop's smallest original face id and its order."""
    if select not in SELECTS:
        raise ValueError(select)
    lo, _start, win_over = _window_starts(sg, z[:, None], band)
    lo, win_over = lo[:, 0], win_over[:, 0]
    flat, base = _flat(sg)
    zmm_w = flat.z_mm[(base + lo)[:, None]
                      + torch.arange(band, device=z.device)]
    crossed, start, end, succ, orig, over, _open = _compact_slice(
        flat, zmm_w, lo, z, k, base
    )
    return raw_loop(crossed, start, end, succ, orig, max_chain,
                    select), win_over | over


def raw_loop(crossed, start, end, succ, orig, max_chain: int,
             select: str) -> RawLoop:
    """The loop that `select` picks among the rows (B, k) of a compaction
    (`_compact_slice`'s crossed, start, end, succ and orig), ordered from
    its member with the smallest original face id: labels, per-label
    sums, the pick and the pointer-jumping order."""
    k = succ.shape[-1]
    orig = orig.to(torch.int64)
    lab = _label_loops(crossed, succ)
    area, centroid, count, mean_pt = _loop_stats(crossed, start, end, lab, k)
    if select == "largest":
        best = torch.argmax(area[:, :k], dim=1)
    else:
        score = torch.abs(mean_pt[:, :k, 0]) + torch.abs(mean_pt[:, :k, 1])
        score = torch.where(count[:, :k] >= 3, score, torch.inf)
        best = torch.argmin(score, dim=1)
    pick = best[:, None]
    n_best = count.gather(1, pick)[:, 0]
    min_orig = torch.full((succ.shape[0], k + 1), _BIG, dtype=torch.int64,
                          device=succ.device)
    min_orig.scatter_reduce_(1, lab, torch.where(crossed, orig, _BIG),
                             reduce="amin")
    is_rep = crossed & (lab == pick) & (orig == min_orig.gather(1, lab))
    points = _order_loop(crossed, start, succ, lab, best, n_best, max_chain,
                         is_rep)
    return RawLoop(points, n_best, area.gather(1, pick)[:, 0],
                   torch.take_along_dim(centroid, pick[..., None],
                                        dim=1)[:, 0])


def _crossing_topology(geom: FaceGeom, z):
    """The crossing structure of every face with plane z (...,), one
    plane per bone of `geom` (..., F, 3); no points.

    Orientation is combinatorial: the traversal enters through the
    (+ -> -) crossed edge and exits through the (- -> +) one.  Returns
    crossed, entry_slot, exit_slot, succ (the face across the exit edge,
    self where there is none or it is uncrossed) and open_edge, each
    (..., F).  Where a plane grazes a vertex and two faces claim one
    successor, the smallest-index one keeps it.
    """
    n_faces, dev = geom.fvz.shape[-2], geom.fvz.device
    d = geom.fvz - torch.as_tensor(z, device=dev)[..., None, None]
    d = torch.where(d == 0.0, 1e-7, d)
    pos = d > 0.0
    pos_next = torch.roll(pos, -1, dims=-1)
    crossed = (pos != pos_next).sum(dim=-1) == 2
    rows = torch.arange(n_faces, device=dev).expand_as(crossed)
    entry_slot = torch.argmax((pos & ~pos_next).to(torch.int8), dim=-1)
    exit_slot = torch.argmax((~pos & pos_next).to(torch.int8), dim=-1)

    succ_raw = geom.neighbors.long().gather(-1, exit_slot[..., None])[..., 0]
    has_nbr = (succ_raw >= 0) & (succ_raw < n_faces)
    succ = torch.where(crossed & has_nbr, succ_raw, rows)
    succ_crossed = crossed.gather(-1, succ)
    open_edge = crossed & ~(has_nbr & succ_crossed)
    succ = torch.where(succ_crossed, succ, rows)
    linked = crossed & (succ != rows)
    pred_min = torch.full(crossed.shape[:-1] + (n_faces + 1,), n_faces,
                          dtype=torch.int64, device=dev)
    pred_min.scatter_reduce_(-1, torch.where(linked, succ, n_faces), rows,
                             reduce="amin")
    succ = torch.where(linked & (pred_min.gather(-1, succ) != rows), rows,
                       succ)
    return crossed, entry_slot, exit_slot, succ, open_edge


def _segment_points(fvx, fvy, fvz, z, entry_slot, exit_slot):
    """(start, end) (..., F, 2): each face's oriented intersection
    segment with plane z (...,), from its crossing slots."""
    d = fvz - torch.as_tensor(z, device=fvz.device)[..., None, None]
    d = torch.where(d == 0.0, 1e-7, d)
    denom = d - torch.roll(d, -1, dims=-1)
    denom = torch.where(torch.abs(denom) < 1e-30, 1.0, denom)
    t = d / denom
    px = fvx + t * (torch.roll(fvx, -1, dims=-1) - fvx)
    py = fvy + t * (torch.roll(fvy, -1, dims=-1) - fvy)

    def at(slot):
        return torch.stack([px.gather(-1, slot[..., None])[..., 0],
                            py.gather(-1, slot[..., None])[..., 0]], dim=-1)

    return at(entry_slot), at(exit_slot)


def _crossing_segments(geom: FaceGeom, z):
    """(crossed, start, end, succ, open_edge) of every face with plane z:
    `_crossing_topology` and the segments of `_segment_points`."""
    crossed, entry_slot, exit_slot, succ, open_edge = _crossing_topology(
        geom, z)
    start, end = _segment_points(geom.fvx, geom.fvy, geom.fvz, z,
                                 entry_slot, exit_slot)
    return crossed, start, end, succ, open_edge


def slice_raw(verts, faces, neighbors, z, max_chain: int = 2048,
              select: str = "largest") -> RawLoop:
    """Single-plane section of the full face set, the raw ordered loop
    (not resampled): one plane z (B,) per bone of verts (B, V, 3), faces
    and neighbors (B, F, 3) in their original face order.

    select='largest' picks the max-area loop; select='central' the loop
    (of at least 3 faces) whose mean point is nearest the z axis.  The
    loop starts at its smallest face id.  As in the JAX package the loop
    is ranked over the whole face set, so a chain that an open edge cuts
    wraps and drops in the order scatter as it does there.

    The crossed faces are packed to the front first (in face order, so
    labels and ties keep their order), which takes one host read: the
    most faces any bone's plane crosses.
    """
    geom = face_geom(verts, faces, neighbors)
    n_faces = faces.shape[-2]
    crossed, start, end, succ, _open = _crossing_segments(geom, z)
    n_cross = crossed.sum(dim=-1)
    k = max(int(n_cross.max()), 1)
    order = torch.argsort((~crossed).to(torch.int8), dim=-1,
                          stable=True)[:, :k]
    rows = torch.arange(k, device=z.device).expand_as(order)
    valid = rows < n_cross[:, None]
    inv = torch.zeros_like(crossed, dtype=torch.int64).scatter_(
        -1, order, rows.contiguous())
    succ_c = torch.where(valid, inv.gather(-1, succ.gather(-1, order)), rows)
    pick = order[..., None].expand(order.shape + (2,))
    start_c, end_c = start.gather(-2, pick), end.gather(-2, pick)

    lab = _label_loops(valid, succ_c)
    area, centroid, count, mean_pt = _loop_stats(valid, start_c, end_c, lab,
                                                 k)
    if select == "largest":
        best = torch.argmax(area[:, :k], dim=1)
    elif select == "central":
        score = torch.abs(mean_pt[:, :k, 0]) + torch.abs(mean_pt[:, :k, 1])
        score = torch.where(count[:, :k] >= 3, score, torch.inf)
        best = torch.argmin(score, dim=1)
    else:
        raise ValueError(select)
    pick = best[:, None]
    n_best = count.gather(1, pick)[:, 0]
    is_rep = valid & (lab == pick) & (rows == pick)
    points = _order_loop(valid, start_c, succ_c, lab, best, n_best,
                         max_chain, is_rep, iters=_iters_for(n_faces))
    return RawLoop(points, n_best, area.gather(1, pick)[:, 0],
                   torch.take_along_dim(centroid, pick[..., None],
                                        dim=1)[:, 0])


def plane_section_points(verts, faces, origin, normal):
    """Every intersection point of an arbitrarily oriented plane (a point
    `origin` (..., 3) and a normal (..., 3)) with a mesh, verts
    (..., V, 3) and faces (..., F, 3): (points (..., F, 3), crossed
    (..., F)), one point per crossed face (its oriented segment's start),
    unordered, as trimesh's section vertices."""
    n = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    d = (verts @ n[..., None])[..., 0] - (origin[..., None, :]
                                          @ n[..., None])[..., 0]
    d = torch.where(d == 0.0, 1e-7, d)
    g = face_geom(verts, faces, None)
    fd = d.gather(-1, faces.long().flatten(-2)).reshape(faces.shape)
    pos = fd > 0.0
    cross_edge = pos != torch.roll(pos, -1, dims=-1)
    crossed = cross_edge.sum(dim=-1) == 2
    fv = torch.stack([g.fvx, g.fvy, g.fvz], dim=-1)        # (..., F, 3, 3)
    denom = fd - torch.roll(fd, -1, dims=-1)
    denom = torch.where(torch.abs(denom) < 1e-30, 1.0, denom)
    t = (fd / denom)[..., None]
    p = fv + t * (torch.roll(fv, -1, dims=-2) - fv)        # per-slot points
    slot = torch.argmax(cross_edge.to(torch.int8), dim=-1)
    points = p.gather(-2, slot[..., None, None].expand(
        slot.shape + (1, 3)))[..., 0, :]
    return points, crossed
