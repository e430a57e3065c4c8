"""Least-squares geometric fits (PyTorch, weight-mask aware).

Port of shoulder_tpu/utils/fits.py: line and plane fits through the
closed-form symmetric 3x3 eigensolver `eigh3`, the centred algebraic sphere
fit, and the Halir-Flusser ellipse fit through the real-root Cardano
solver `_eig3`.  Every fit takes an optional per-point weight vector so
masked point sets fit with static shapes.
"""

from __future__ import annotations

import math

import torch


def _weights(pts, w):
    if w is None:
        return torch.ones(pts.shape[0], dtype=pts.dtype, device=pts.device)
    return w.to(pts.dtype)


def _weighted_mean(pts, w):
    return torch.sum(pts * w[:, None], dim=0) / torch.sum(w)


def _null3(a):
    """Unit null-space vector of a (numerically) rank-2 3x3 matrix."""
    cands = torch.stack([
        torch.linalg.cross(a[0], a[1]),
        torch.linalg.cross(a[0], a[2]),
        torch.linalg.cross(a[1], a[2]),
    ])
    norms = torch.linalg.vector_norm(cands, dim=1)
    v = cands.index_select(0, torch.argmax(norms).view(1))[0]
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)


def eigh3(a):
    """Closed-form eigendecomposition of a symmetric 3x3 matrix.

    Returns (vals (3,), vecs (3,3)) in ascending order (eigenvector signs
    are arbitrary), the convention of torch.linalg.eigh.
    """
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.trace(a) / 3.0
    a_q = a - q * eye
    p2 = torch.sum(a_q * a_q) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(torch.linalg.det(a_q) / (2.0 * p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    mid = 3.0 * q - hi - lo
    vals = torch.stack([lo, mid, hi])

    v_hi = _null3(a - hi * eye)
    v_lo = _null3(a - lo * eye)
    v_mid = torch.linalg.cross(v_hi, v_lo)
    v_mid = v_mid / torch.clamp(torch.linalg.vector_norm(v_mid), min=1e-30)
    vecs = torch.stack([v_lo, v_mid, v_hi], dim=1)
    # degenerate (near-spherical) scatter: any orthonormal basis is valid
    degenerate = p2 < 1e-20
    vals = torch.where(degenerate, q.expand(3), vals)
    vecs = torch.where(degenerate, eye, vecs)
    return vals, vecs


def fit_line(pts, w=None):
    """Best-fit 3D line: (point, direction), direction the principal
    eigenvector of the weighted scatter matrix."""
    w = _weights(pts, w)
    center = _weighted_mean(pts, w)
    x = (pts - center) * torch.sqrt(w)[:, None]
    _, vecs = eigh3(x.T @ x)
    return center, vecs[:, -1]


def fit_plane(pts, w=None):
    """Best-fit plane: (point, normal), normal the least-principal
    eigenvector."""
    w = _weights(pts, w)
    center = _weighted_mean(pts, w)
    x = (pts - center) * torch.sqrt(w)[:, None]
    _, vecs = eigh3(x.T @ x)
    return center, vecs[:, 0]


def fit_sphere(pts, w=None):
    """Algebraic sphere fit on mean-centred points: (radius, center)."""
    w = _weights(pts, w)
    mean = _weighted_mean(pts, w)
    q = pts - mean
    ones = torch.ones((q.shape[0], 1), dtype=q.dtype, device=q.device)
    a = torch.cat([2.0 * q, ones], dim=1)
    f = torch.sum(q**2, dim=1)
    aw = a * w[:, None]
    ata = aw.T @ a
    atf = aw.T @ f
    eye = torch.eye(4, dtype=a.dtype, device=a.device)
    c = torch.linalg.solve_ex(ata + 1e-6 * eye, atf).result
    radius = torch.sqrt(torch.clamp(c[0]**2 + c[1]**2 + c[2]**2 + c[3], min=0.0))
    return radius, c[:3] + mean


def _eig3(m):
    """Real parts of the eigenpairs of a real 3x3 matrix via Cardano's
    formula; complex pairs come back with garbage eigenvectors, which
    fit_ellipse's 4ac - b^2 > 0 selection never picks."""
    tr = torch.trace(m)
    m2 = (
        m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        + m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]
        + m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
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
    t_trig = rho * torch.cos(theta / 3.0 - 2.0 * math.pi * ks / 3.0)
    t_roots = torch.where(disc > 0, t_single.expand(3), t_trig)
    vals = t_roots + tr / 3.0
    vals = torch.where(torch.isfinite(vals), vals, 0.0)
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    vecs = torch.stack([_null3(m - vals[k] * eye) for k in range(3)], dim=1)
    return vals, vecs


def fit_ellipse(pts2d, w=None):
    """Direct least-squares (Halir-Flusser) ellipse fit.

    Returns (center (2,), width, height, phi) as lsq-ellipse's
    as_parameters().
    """
    w = _weights(pts2d, w)
    mean = _weighted_mean(pts2d, w)
    xy = pts2d - mean
    scale = torch.sqrt(torch.sum(w[:, None] * xy**2, dim=0) / torch.sum(w))
    scale = torch.clamp(scale, min=1e-12)
    x = xy[:, 0] / scale[0]
    y = xy[:, 1] / scale[1]

    sw = torch.sqrt(w)
    d1 = torch.stack([x**2, x * y, y**2], dim=1) * sw[:, None]
    d2 = torch.stack([x, y, torch.ones_like(x)], dim=1) * sw[:, None]
    s1 = d1.T @ d1
    s2 = d1.T @ d2
    s3 = d2.T @ d2
    t = -torch.linalg.solve_ex(s3, s2.T).result
    m = s1 + s2 @ t
    c1inv = torch.tensor([[0.0, 0.0, 0.5], [0.0, -1.0, 0.0], [0.5, 0.0, 0.0]],
                         dtype=m.dtype, device=m.device)
    m = c1inv @ m
    vals, vecs = _eig3(m)
    cond = 4.0 * vecs[0] * vecs[2] - vecs[1] ** 2
    cond = torch.where(torch.isfinite(cond), cond, -torch.inf)
    a1 = vecs.index_select(1, torch.argmax(cond).view(1))[:, 0]
    a2 = t @ a1
    a_, b_, c_ = a1[0], a1[1], a1[2]
    d_, e_, f_ = a2[0], a2[1], a2[2]

    sx, sy = scale[0], scale[1]
    mx, my = mean[0], mean[1]
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
    return torch.stack([cx, cy]), axis1, axis2, phi
