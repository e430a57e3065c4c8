"""A contour stack (ops/slicing.py slice_stack), counted from its inputs
(chip_smoke.py's slice_stack_work): each z_mm row of the union of the
planes' windows, each fvt/ids row of a kept crossed face, each z_key
entry the binary searches touch and each cummax_z_max entry the overflow
tests read (at lo - 1, lo > 0) read once, one z per plane; every output
written once.  Operations: about 40 float32 per kept face (segment,
moments, arc length) and 20 per sample.  A batch's (zs (B, S)) is the
sum of its bones' (each reads only its own faces)."""

from __future__ import annotations

import numpy as np
import torch

HOOKS = (("ops.slicing", "slice_stack"),)
PRECISION = "fp32"
RANGES = ()
KERNELS = ("slice_stack_kernel",)


def searched_keys(z_key, zs):
    """Distinct z_key entries that binary searches of the planes read
    (searchsorted, side left): the least the window search needs.  The
    top levels are the same keys for every plane, and count once."""
    keys, zs = z_key.cpu().numpy(), zs.cpu().numpy()
    a = np.zeros(zs.shape, np.int64)
    b = np.full(zs.shape, keys.shape[0], np.int64)
    seen = set()
    while (live := a < b).any():
        mid = (a + b) >> 1
        seen.update(mid[live].tolist())
        right = live & (keys[np.minimum(mid, keys.shape[0] - 1)] < zs)
        a = np.where(right, mid + 1, a)
        b = np.where(live & ~right, mid, b)
    return len(seen)


def stack_work(slicing, sg, zs, interp_num, band, k):
    """(bytes, operations) of one stack; `slicing` is the frozen copy's
    ops/slicing.py (its SortedGeom and window search)."""
    if zs.dim() == 2:
        return tuple(map(sum, zip(*(
            stack_work(slicing, slicing.SortedGeom(*(x[b] for x in sg)),
                       zs[b], interp_num, band, k)
            for b in range(zs.shape[0])))))
    n_faces, n_planes = sg.z_key.shape[0], zs.shape[0]
    los, _starts, _over = slicing._window_starts(sg, zs, band)
    cummax_read = int(torch.unique(los[los > 0]).numel())
    cover = np.zeros(n_faces + 1, np.int64)
    np.add.at(cover, los.cpu().numpy(), 1)
    np.add.at(cover, los.cpu().numpy() + band, -1)
    window_rows = int((np.cumsum(cover)[:n_faces] > 0).sum())
    idx = los[:, None] + torch.arange(band, device=zs.device)
    zmm = sg.z_mm[idx]
    crossed = (zmm[..., 1] >= zs[:, None]) & (zmm[..., 0] < zs[:, None])
    kept = crossed & (torch.cumsum(crossed, dim=1) <= k)
    gathered = int(torch.unique(idx[kept]).numel())
    reads = (window_rows * 8 + gathered * (9 * 4 + 4 * 4)
             + searched_keys(sg.z_key, zs) * 4 + cummax_read * 4
             + n_planes * 4)
    writes = n_planes * (interp_num * 8 + 8 + 4 + 4 + 1 + 1)
    ops = 40 * int(kept.sum()) + 20 * n_planes * interp_num
    return reads + writes, ops


def work(fn, args, kwargs, result):
    from benchmark.reference.frozen.ops import slicing

    sg, zs, interp_num, band = args[:4]
    compact_k = args[4] if len(args) > 4 else kwargs.get("compact_k", 512)
    band = min(band, sg.z_key.shape[-1])
    return stack_work(slicing, sg, zs, interp_num, band, min(compact_k, band))
