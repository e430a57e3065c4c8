"""Isosurface extraction by marching tetrahedra on the Kuhn lattice
(PyTorch).

Port of shoulder_tpu/ops/marching_tets.py, the CT path's volume ->
surface step.  Each lattice cube splits into the 6 tetrahedra of the
translation-invariant Kuhn subdivision, so shared faces get matching
diagonals and the output welds watertight.  The work is dense
elementwise PyTorch on the volume's device: one activity pass over the
full lattice, a stable compaction of the active tetrahedra, triangle
emission for those only, and a stable compaction of the valid
triangles.

Equal to the JAX function element for element up to float rounding: the
same tables, the same (cube, tet, triangle) order of the output, the same
silent truncation at `max_active` and `max_tris`.  The compactions are
`torch.nonzero` (index order, so stable), which is what the JAX
function's `argsort(~mask, stable=True)` keeps; its padding rows past the
active count are invalid and never reach the output.  Every lattice edge
interpolates in one canonical direction (from its smaller flat voxel id),
with the arithmetic in separate eager ops (no fused multiply-add), so a
shared edge gives the same bits in every tetrahedron that has it.
Orientation is fixed numerically per triangle (normal from the inside
corners towards the outside ones).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from shoulder_tpu_torch.utils import trace

# Kuhn subdivision: 6 monotone corner paths (0,0,0) -> (1,1,1).
# Corner offsets per tet: v0=(0,0,0), v1=e[p0], v2=e[p0]+e[p1], v3=(1,1,1).
_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def _tet_corner_offsets():
    eye = np.eye(3, dtype=np.int32)
    tets = []
    for p in _PERMS:
        v0 = np.zeros(3, np.int32)
        v1 = eye[p[0]]
        v2 = eye[p[0]] + eye[p[1]]
        v3 = np.ones(3, np.int32)
        tets.append([v0, v1, v2, v3])
    return np.asarray(tets)  # (6, 4, 3)


_TET_OFFSETS = _tet_corner_offsets()

# number of triangles for a 4-bit inside mask (popcount 0..4 -> 0,1,2,1,0
# triangles; 2-inside emits a quad = 2 triangles)
_N_TRIS = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], np.int32
)

# per-case edge lists: each triangle is 3 edges, each edge is a (u, v)
# corner pair whose crossing point is a triangle vertex.  Cases with one
# vertex "odd one out" (masks with popcount 1 or 3) use its 3 incident
# edges; popcount-2 masks split the quad (i,k),(i,l),(j,l) + (i,k),(j,l),(j,k)
# where i,j inside and k,l outside.


def _case_edges():
    edges = np.zeros((16, 2, 3, 2), np.int32)  # (case, tri, vtx, {u,v})
    for mask in range(16):
        inside = [i for i in range(4) if mask >> i & 1]
        outside = [i for i in range(4) if not mask >> i & 1]
        if len(inside) == 1:
            i = inside[0]
            tri = [(i, outside[0]), (i, outside[1]), (i, outside[2])]
            edges[mask, 0] = tri
        elif len(inside) == 3:
            k = outside[0]
            tri = [(k, inside[0]), (k, inside[1]), (k, inside[2])]
            edges[mask, 0] = tri
        elif len(inside) == 2:
            i, j = inside
            k, l = outside
            edges[mask, 0] = [(i, k), (i, l), (j, l)]
            edges[mask, 1] = [(i, k), (j, l), (j, k)]
    return edges


_CASE_EDGES = _case_edges()


class TriangleSoup(NamedTuple):
    triangles: torch.Tensor  # (rows, 3, 3) f32, zeros past count; rows =
    #                          min(max_tris, 2 * min(max_active, tets))
    count: torch.Tensor      # () int32 valid triangles


def _take(x, idx):
    """x (A, 4, ...) gathered along dim 1 by idx (A, 2, 3): (A, 2, 3, ...)."""
    a = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[a, idx]


@trace.spanned("ct.marching_tets")
def marching_tets(
    volume,
    iso: float,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    max_active: int = 262144,
    max_tris: int = 393216,
) -> TriangleSoup:
    """Extract the iso-surface of a (D, H, W) scalar volume tensor, on the
    volume's device.

    "Inside" is volume > iso.  Returns a padded triangle soup in world
    coordinates (origin + index * spacing, xyz = (w, h, d)); weld on the
    host for an indexed mesh (io/stl.weld).
    """
    vol = volume.to(torch.float32)
    dev = vol.device
    D, H, W = vol.shape
    nd, nh, nw = D - 1, H - 1, W - 1
    origin = torch.tensor(origin, dtype=torch.float32, device=dev)
    spacing = torch.tensor(spacing, dtype=torch.float32, device=dev)
    offs = torch.as_tensor(_TET_OFFSETS, dtype=torch.int64, device=dev)
    n_tris = torch.as_tensor(_N_TRIS, device=dev)

    # per-tet 4-bit inside mask over the full lattice, cube-major
    inside = (vol > iso).to(torch.uint8)
    masks = torch.empty((nd, nh, nw, 6), dtype=torch.uint8, device=dev)
    for t in range(6):
        m = torch.zeros((nd, nh, nw), dtype=torch.uint8, device=dev)
        for c in range(4):
            o = _TET_OFFSETS[t, c]
            m |= inside[o[0]:o[0] + nd, o[1]:o[1] + nh, o[2]:o[2] + nw] << c
        masks[..., t] = m
    mask_all = masks.reshape(-1)

    # compact the active tets (neither all outside nor all inside)
    act_ids = torch.nonzero((mask_all != 0) & (mask_all != 15))[:max_active, 0]
    act_mask = mask_all[act_ids].to(torch.int64)

    cube_id = act_ids // 6
    tet_id = act_ids % 6
    ci = cube_id // (nh * nw)
    cj = (cube_id // nw) % nh
    ck = cube_id % nw
    cube_idx = torch.stack([ci, cj, ck], dim=1)            # (A, 3) d,h,w

    # the 4 corner values + positions per active tet
    corner_idx = cube_idx[:, None, :] + offs[tet_id]       # (A, 4, 3)
    vals = vol[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    # world positions: index order is (z, y, x) = (d, h, w); map to xyz
    pos = origin + corner_idx.flip(-1).to(torch.float32) * spacing

    # up to 2 triangles per tet from the case edge table
    e = torch.as_tensor(_CASE_EDGES, dtype=torch.int64, device=dev)[act_mask]
    u, v = e[..., 0], e[..., 1]                            # (A, 2, 3)
    # canonical interpolation direction per lattice edge (the host weld
    # is exact-match)
    flat_id = corner_idx[..., 0] * (H * W) + corner_idx[..., 1] * W \
        + corner_idx[..., 2]                               # (A, 4)
    swap = _take(flat_id, u) > _take(flat_id, v)
    u, v = torch.where(swap, v, u), torch.where(swap, u, v)
    val_u, val_v = _take(vals, u), _take(vals, v)
    denom = val_v - val_u
    denom = torch.where(torch.abs(denom) < 1e-20, 1.0, denom)
    t_par = torch.clamp((iso - val_u) / denom, 0.0, 1.0)
    p_u, p_v = _take(pos, u), _take(pos, v)
    tri = p_u + t_par[..., None] * (p_v - p_u)             # (A, 2, 3, 3)
    tri_valid = torch.arange(2, device=dev) < n_tris[act_mask][:, None]

    # orient: the normal points from the inside corners to the outside ones
    bits = ((act_mask[:, None] >> torch.arange(4, device=dev)) & 1).to(
        torch.float32)                                     # (A, 4)
    n_in = bits.sum(dim=1, keepdim=True)
    cen_in = (pos * bits[..., None]).sum(dim=1) / torch.clamp(n_in, min=1)
    cen_out = (pos * (1 - bits)[..., None]).sum(dim=1) / torch.clamp(
        4 - n_in, min=1)
    grad = cen_out - cen_in                                # (A, 3)
    nrm = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0],
                             tri[:, :, 2] - tri[:, :, 0], dim=-1)
    flip = (nrm * grad[:, None, :]).sum(dim=-1) < 0        # (A, 2)
    tri = torch.where(flip[..., None, None], tri[:, :, [0, 2, 1], :], tri)

    # final compaction; the JAX function's padded (max_active, 2) triangle
    # rows bound its output rows too
    rows = min(max_tris, 2 * min(max_active, 6 * nd * nh * nw))
    keep = torch.nonzero(tri_valid.reshape(-1))[:rows, 0]
    out = torch.zeros((rows, 3, 3), dtype=torch.float32, device=dev)
    out[:keep.shape[0]] = tri.reshape(-1, 3, 3)[keep]
    count = torch.clamp(tri_valid.sum(), max=rows).to(torch.int32)
    return TriangleSoup(out, count)
