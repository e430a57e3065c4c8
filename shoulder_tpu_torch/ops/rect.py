"""Minimum rotated rectangle and polygon end-cutting (PyTorch).

Port of shoulder_tpu/ops/rect.py.  The rectangle comes from a two-stage
dense angle sweep over a period of pi/2: 512 coarse angles, then 64 fine
angles within one coarse step of the best.  `min_rotated_rect` takes a
leading row dimension (slices, a bone batch folded in); the end-cutting
functions take leading batch dimensions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from shoulder_tpu_torch.utils.geometry import linspace

_N_DIRS = 512


class RotatedRect(NamedTuple):
    center: torch.Tensor        # (..., 2)
    major_dir: torch.Tensor     # (..., 2) unit vector along the long axis
    major_extent: torch.Tensor  # (...)
    minor_extent: torch.Tensor  # (...)


def _sweep(pts, angs):
    """Rectangle stats of point sets pts (S, N, 2) at angles angs (S, D):
    (area, du, dv, pu_mid, pv_mid), each (S, D)."""
    u = torch.stack([torch.cos(angs), torch.sin(angs)], dim=2)   # (S, D, 2)
    v = torch.stack([-u[..., 1], u[..., 0]], dim=2)
    pu = pts @ u.transpose(1, 2)                                 # (S, N, D)
    pv = pts @ v.transpose(1, 2)
    pu_max, pu_min = pu.amax(dim=1), pu.amin(dim=1)
    pv_max, pv_min = pv.amax(dim=1), pv.amin(dim=1)
    du = pu_max - pu_min
    dv = pv_max - pv_min
    return du * dv, du, dv, 0.5 * (pu_max + pu_min), 0.5 * (pv_max + pv_min)


def min_rotated_rect(pts) -> RotatedRect:
    """Minimum-area rotated rectangle of each point set pts (S, N, 2)."""
    n_sets = pts.shape[0]
    half_pi = math.pi / 2.0
    coarse = linspace(0.0, half_pi, _N_DIRS, endpoint=False,
                      device=pts.device)
    area_c, *_ = _sweep(pts, coarse.expand(n_sets, _N_DIRS))
    k = torch.argmin(area_c, dim=1)
    step = half_pi / _N_DIRS
    fine = coarse[k][:, None] + linspace(-step, step, 64,
                                         device=pts.device)[None, :]
    area_f, du, dv, pum, pvm = _sweep(pts, fine)
    j = torch.argmin(area_f, dim=1, keepdim=True)

    def pick(a):
        return a.gather(1, j)[:, 0]

    ang = pick(fine)
    uk = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    vk = torch.stack([-uk[:, 1], uk[:, 0]], dim=1)
    duk, dvk = pick(du), pick(dv)
    center = pick(pum)[:, None] * uk + pick(pvm)[:, None] * vk
    major_is_u = (duk >= dvk)[:, None]
    major_dir = torch.where(major_is_u, uk, vk)
    major_extent = torch.where(major_is_u[:, 0], duk, dvk)
    minor_extent = torch.where(major_is_u[:, 0], dvk, duk)
    return RotatedRect(center, major_dir, major_extent, minor_extent)


def end_slab_mask(pts, rect: RotatedRect, yscale: float):
    """Points (..., N, 2) beyond the slightly shrunk rectangle ends along
    the major axis: |major coordinate - center| > yscale * major_extent /
    2."""
    y = torch.matmul(pts - rect.center[..., None, :],
                     rect.major_dir[..., :, None])[..., 0]
    return torch.abs(y) > yscale * rect.major_extent[..., None] / 2.0, y


def cyclic_runs(mask, max_runs: int):
    """Label contiguous cyclic runs of True in boolean rings (..., n): run
    ids in [0, max_runs) (later runs share the last id), -1 where False.
    Runs are counted from each ring's first False element (index 0 if
    none)."""
    n = mask.shape[-1]
    first_false = torch.argmin(mask.to(torch.int8), dim=-1, keepdim=True)
    idx = (torch.arange(n, device=mask.device) + first_false) % n
    m = mask.gather(-1, idx)
    starts = m & ~torch.roll(m, 1, dims=-1)
    starts[..., 0] = m[..., 0]
    rid = torch.cumsum(starts.to(torch.int64), dim=-1) - 1
    rid = torch.where(m, torch.clamp(rid, max=max_runs - 1), -1)
    return torch.zeros_like(rid).scatter_(-1, idx, rid)


def run_chord_centroids(pts, run_id, max_runs: int):
    """Mean point of each run's arc points (the cut-off end caps are
    hair-thin slivers, so this is the sliver centroid to within its
    depth), for rings pts (..., N, 2) and run_id (..., N).  Returns
    (centroids (..., max_runs, 2), counts (..., max_runs), valid
    (..., max_runs))."""
    # sums over a (..., N, max_runs) run mask, not float atomics, so they
    # come out the same in every run
    in_run = run_id[..., :, None] == torch.arange(max_runs,
                                                  device=pts.device)
    counts = in_run.sum(dim=-2)
    sums = torch.where(in_run[..., None], pts[..., :, None, :], 0.0).sum(
        dim=-3)
    cent = sums / torch.clamp(counts, min=1)[..., None]
    return cent, counts, counts > 0
