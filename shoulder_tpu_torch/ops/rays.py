"""Batched Möller-Trumbore ray-triangle intersection (PyTorch).

Port of shoulder_tpu/ops/rays.py: a handful of rays against every
triangle of the mesh, dense, no spatial index; a bone batch is a leading
dimension of the mesh and the rays.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _corner(verts, faces, j):
    """Corner j of every face, (..., F, 3), gathered per mesh."""
    idx = faces[..., j].long()[..., None].expand(faces.shape[:-1] + (3,))
    return verts.gather(-2, idx)


def first_hits(verts, faces, origins, directions):
    """Nearest positive-t hit of each ray (..., R) with a triangle soup
    (verts (..., V, 3), faces (..., F, 3)).

    Returns (points (..., R, 3), ts (..., R), hits (..., R)): a ray that
    hits nothing returns its origin and t = inf.  Padded (degenerate)
    faces never hit because their edge cross products vanish.
    """
    v0 = _corner(verts, faces, 0)[..., None, :, :]  # (..., 1, F, 3)
    e1 = _corner(verts, faces, 1)[..., None, :, :] - v0
    e2 = _corner(verts, faces, 2)[..., None, :, :] - v0
    o = origins[..., :, None, :]                    # (..., R, 1, 3)
    d = directions[..., :, None, :].expand(
        directions.shape[:-1] + e2.shape[-2:])

    pvec = torch.linalg.cross(d, e2.expand_as(d))
    det = torch.sum(e1 * pvec, dim=-1)
    ok = torch.abs(det) > _EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv
    qvec = torch.linalg.cross(tvec, e1.expand_as(tvec))
    v = torch.sum(d * qvec, dim=-1) * inv
    t = torch.sum(e2 * qvec, dim=-1) * inv

    hit = (ok & (u >= -_EPS) & (v >= -_EPS) & (u + v <= 1.0 + _EPS)
           & (t > 1e-5))
    t_masked = torch.where(hit, t, torch.inf)
    k = torch.argmin(t_masked, dim=-1, keepdim=True)
    any_hit = hit.gather(-1, k)[..., 0]
    t_best = t_masked.gather(-1, k)[..., 0]
    point = origins + t_best[..., None] * directions
    point = torch.where(any_hit[..., None], point, origins)
    return point, t_best, any_hit
