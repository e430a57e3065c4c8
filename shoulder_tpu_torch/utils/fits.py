"""Least-squares geometric fits (PyTorch, weight-mask aware).

Port of shoulder_tpu/utils/fits.py: line and plane fits through the
closed-form symmetric 3x3 eigensolver `eigh3`, the centred algebraic sphere
fit, and the Halir-Flusser ellipse fit through the real-root Cardano
solver `_eig3`.  Every fit takes an optional per-point weight vector so
masked point sets fit with static shapes, and leading batch dimensions
(points (..., N, D), weights (..., N)), where the JAX package vmaps.
"""

from __future__ import annotations

import math

import torch


def _weights(pts, w):
    if w is None:
        return torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    return w.to(pts.dtype)


def _weighted_mean(pts, w):
    return (torch.sum(pts * w[..., None], dim=-2)
            / torch.sum(w, dim=-1)[..., None])


def _t(x):
    return x.transpose(-1, -2)


def gram(a, b):
    """a^T b over the point axis: (..., N, I) x (..., N, J) -> (..., I, J),
    as a sum of outer products.  With a batch dim, a matrix product this
    shaped (a few outputs, a long inner axis) runs in cuBLAS as one small
    tile per bone that walks the whole inner axis (148 ms for a batch's 21
    such products at 262,144 points on an H100); the reduction spreads
    over the card, and its order does not depend on the batch size."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def _trace(a):
    return a.diagonal(dim1=-2, dim2=-1).sum(dim=-1)


def _null3(a):
    """Unit null-space vectors of (numerically) rank-2 3x3 matrices
    (..., 3, 3)."""
    cands = torch.stack([
        torch.linalg.cross(a[..., 0, :], a[..., 1, :]),
        torch.linalg.cross(a[..., 0, :], a[..., 2, :]),
        torch.linalg.cross(a[..., 1, :], a[..., 2, :]),
    ], dim=-2)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1)[..., None, None]
    v = torch.take_along_dim(cands, best, dim=-2)[..., 0, :]
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def eigh3(a):
    """Closed-form eigendecomposition of symmetric 3x3 matrices (..., 3, 3).

    Returns (vals (..., 3), vecs (..., 3, 3)) in ascending order
    (eigenvector signs are arbitrary), the convention of torch.linalg.eigh.
    """
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = _trace(a) / 3.0
    a_q = a - q[..., None, None] * eye
    p2 = torch.sum(a_q * a_q, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(torch.linalg.det(a_q) / (2.0 * p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    mid = 3.0 * q - hi - lo
    vals = torch.stack([lo, mid, hi], dim=-1)

    v_hi = _null3(a - hi[..., None, None] * eye)
    v_lo = _null3(a - lo[..., None, None] * eye)
    v_mid = torch.linalg.cross(v_hi, v_lo)
    v_mid = v_mid / torch.clamp(
        torch.linalg.vector_norm(v_mid, dim=-1, keepdim=True), min=1e-30)
    vecs = torch.stack([v_lo, v_mid, v_hi], dim=-1)
    # degenerate (near-spherical) scatter: any orthonormal basis is valid
    degenerate = p2 < 1e-20
    vals = torch.where(degenerate[..., None], q[..., None], vals)
    vecs = torch.where(degenerate[..., None, None], eye, vecs)
    return vals, vecs


def _scatter(pts, w):
    """Weighted mean and scatter matrix of point sets (..., N, 3)."""
    center = _weighted_mean(pts, w)
    x = (pts - center[..., None, :]) * torch.sqrt(w)[..., None]
    return center, gram(x, x)


def fit_line(pts, w=None):
    """Best-fit 3D lines: (point, direction), direction the principal
    eigenvector of the weighted scatter matrix."""
    center, scatter = _scatter(pts, _weights(pts, w))
    _, vecs = eigh3(scatter)
    return center, vecs[..., -1]


def fit_plane(pts, w=None):
    """Best-fit planes: (point, normal), normal the least-principal
    eigenvector."""
    center, scatter = _scatter(pts, _weights(pts, w))
    _, vecs = eigh3(scatter)
    return center, vecs[..., 0]


def fit_sphere(pts, w=None):
    """Algebraic sphere fit on mean-centred points: (radius, center)."""
    w = _weights(pts, w)
    mean = _weighted_mean(pts, w)
    q = pts - mean[..., None, :]
    ones = torch.ones(q.shape[:-1] + (1,), dtype=q.dtype, device=q.device)
    a = torch.cat([2.0 * q, ones], dim=-1)
    f = torch.sum(q**2, dim=-1)
    # A^T W [A | f] in one sum
    normal = gram(a * w[..., None], torch.cat([a, f[..., None]], dim=-1))
    eye = torch.eye(4, dtype=a.dtype, device=a.device)
    c = torch.linalg.solve_ex(normal[..., :4] + 1e-6 * eye,
                              normal[..., 4]).result
    radius = torch.sqrt(torch.clamp(
        c[..., 0]**2 + c[..., 1]**2 + c[..., 2]**2 + c[..., 3], min=0.0))
    return radius, c[..., :3] + mean


def _eig3(m):
    """Real parts of the eigenpairs of real 3x3 matrices (..., 3, 3) via
    Cardano's formula; complex pairs come back with garbage eigenvectors,
    which fit_ellipse's 4ac - b^2 > 0 selection never picks."""
    tr = _trace(m)
    m2 = (
        m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        + m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        + m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    )
    det = torch.linalg.det(m)
    p = m2 - tr**2 / 3.0
    q = -det + tr * m2 / 3.0 - 2.0 * tr**3 / 27.0
    disc = q**2 / 4.0 + p**3 / 27.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))

    def cbrt(x):
        return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)

    t_single = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq)
    p_neg = torch.clamp(p, max=-1e-30)
    rho = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * rho), -1.0, 1.0)
    theta = torch.arccos(arg)
    ks = torch.arange(3, dtype=m.dtype, device=m.device)
    t_trig = rho[..., None] * torch.cos(theta[..., None] / 3.0
                                        - 2.0 * math.pi * ks / 3.0)
    t_roots = torch.where(disc[..., None] > 0, t_single[..., None], t_trig)
    vals = t_roots + tr[..., None] / 3.0
    vals = torch.where(torch.isfinite(vals), vals, 0.0)
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    vecs = torch.stack([_null3(m - vals[..., k, None, None] * eye)
                        for k in range(3)], dim=-1)
    return vals, vecs


def fit_ellipse(pts2d, w=None):
    """Direct least-squares (Halir-Flusser) ellipse fit.

    Returns (center (..., 2), width, height, phi) as lsq-ellipse's
    as_parameters().
    """
    w = _weights(pts2d, w)
    mean = _weighted_mean(pts2d, w)
    xy = pts2d - mean[..., None, :]
    scale = torch.sqrt(torch.sum(w[..., None] * xy**2, dim=-2)
                       / torch.sum(w, dim=-1)[..., None])
    scale = torch.clamp(scale, min=1e-12)
    x = xy[..., 0] / scale[..., 0:1]
    y = xy[..., 1] / scale[..., 1:2]

    sw = torch.sqrt(w)[..., None]
    d = torch.stack([x**2, x * y, y**2, x, y, torch.ones_like(x)],
                    dim=-1) * sw
    dd = gram(d, d)                     # [[s1, s2], [s2^T, s3]]
    s1, s2, s3 = dd[..., :3, :3], dd[..., :3, 3:], dd[..., 3:, 3:]
    t = -torch.linalg.solve_ex(s3, _t(s2)).result
    m = s1 + s2 @ t
    # [[0, 0, 0.5], [0, -1, 0], [0.5, 0, 0]], made on the device
    c1inv = torch.zeros((3, 3), dtype=m.dtype, device=m.device)
    c1inv[0, 2] = c1inv[2, 0] = 0.5
    c1inv[1, 1] = -1.0
    m = c1inv @ m
    vals, vecs = _eig3(m)
    cond = 4.0 * vecs[..., 0, :] * vecs[..., 2, :] - vecs[..., 1, :] ** 2
    cond = torch.where(torch.isfinite(cond), cond, -torch.inf)
    pick = torch.argmax(cond, dim=-1)[..., None, None]
    a1 = torch.take_along_dim(vecs, pick, dim=-1)[..., 0]
    a2 = (t @ a1[..., None])[..., 0]
    a_, b_, c_ = a1[..., 0], a1[..., 1], a1[..., 2]
    d_, e_, f_ = a2[..., 0], a2[..., 1], a2[..., 2]

    sx, sy = scale[..., 0], scale[..., 1]
    mx, my = mean[..., 0], mean[..., 1]
    A = a_ / sx**2
    B = b_ / (sx * sy)
    C = c_ / sy**2
    D = -2 * A * mx - B * my + d_ / sx
    E = -2 * C * my - B * mx + e_ / sy
    F = (
        A * mx**2 + B * mx * my + C * my**2
        - (d_ / sx) * mx - (e_ / sy) * my + f_
    )

    den = B**2 - 4 * A * C
    cx = (2 * C * D - B * E) / den
    cy = (2 * A * E - B * D) / den
    num = 2 * (A * E**2 + C * D**2 + F * B**2 - B * D * E - 4 * A * C * F)
    s = torch.sqrt((A - C) ** 2 + B**2)
    axis1 = -torch.sqrt(num * (A + C + s)) / den
    axis2 = -torch.sqrt(num * (A + C - s)) / den
    phi = 0.5 * torch.atan2(B, A - C)
    return torch.stack([cx, cy], dim=-1), axis1, axis2, phi
