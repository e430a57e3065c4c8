"""Rigid-transform and coordinate-system math (PyTorch).

Port of shoulder_tpu/utils/geometry.py: the same formulas on torch
tensors.  Functions take tensors and return tensors on the same device;
every one takes leading batch dimensions (a bone batch), where the JAX
package vmaps.  `host_f32` runs one of them on numpy inputs the way the
JAX facade does.
"""

from __future__ import annotations

import numpy as np
import torch


def host_f32(fn, *arrays) -> np.ndarray:
    """fn over float32 CPU tensors of numpy `arrays`, as a numpy float32
    array.  The JAX facade calls the geometry on float64 numpy inputs
    with x64 off, so JAX computes and returns them in float32."""
    args = (torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in arrays)
    return fn(*args).numpy()


def linspace(start, stop, num: int, endpoint: bool = True, device=None):
    """float32 `jnp.linspace` with its formula, start*(1-s) + stop*s for
    s = i/div.  XLA compiles JAX's division by div into a product with its
    float32 reciprocal, so a compiled JAX grid can differ from this one by
    an ulp at some points (19 of a 200-plane stack).  `start` and
    `stop` may be numbers or tensors of one shape (...,) (their device is
    used): the result is (..., num), one grid per start/stop pair.  A
    number becomes a device tensor by a fill, not a host copy, so the
    call never waits for the device."""

    def f32(x, dev):
        if torch.is_tensor(x):
            return x.to(device=dev if dev is not None else x.device,
                        dtype=torch.float32)
        return torch.full((), x, dtype=torch.float32, device=dev)

    start = f32(start, device)
    stop = f32(stop, start.device)
    start, stop = torch.broadcast_tensors(start, stop)
    div = num - 1 if endpoint else num
    s = torch.arange(div, dtype=torch.float32, device=start.device) / div
    out = start[..., None] * (1 - s) + stop[..., None] * s
    if endpoint:
        out = torch.cat([out, stop[..., None]], dim=-1)
    return out


def _last_row(top):
    """[0, 0, 0, 1] under a (..., 3, 4) block, as a (..., 4, 4) matrix."""
    last = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                       device=top.device)
    last[..., 0, 3] = 1.0
    return torch.cat([top, last], dim=-2)


def transform_pts(pts, transform):
    """Apply 4x4 homogeneous transforms (..., 4, 4) to points (..., N, 3)."""
    return (pts @ transform[..., :3, :3].transpose(-1, -2)
            + transform[..., None, :3, 3])


def transform_vecs(vecs, transform):
    """Rotate direction vectors (..., N, 3) by the rotation parts of
    transforms (..., 4, 4)."""
    return vecs @ transform[..., :3, :3].transpose(-1, -2)


def inv_transform(transform):
    """Invert rigid 4x4 transforms (..., 4, 4) as [R^-1, -R^-1 t] (general
    3x3 inverse, as the reference does)."""
    rot_inv = torch.linalg.inv_ex(transform[..., :3, :3]).inverse
    t = transform[..., :3, 3:]
    return _last_row(torch.cat([rot_inv, -rot_inv @ t], dim=-1))


def translate_transform(translation):
    """4x4 transform from a 3-vector translation."""
    out = torch.eye(4, dtype=translation.dtype, device=translation.device)
    out[:3, 3] = translation.reshape(3)
    return out


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def unit_vector(p1, p2):
    """Unit vectors p1 - p2 along the last axis."""
    vec = p1 - p2
    return vec / _norm(vec)


def construct_csys(vec_z, vec_y):
    """CT->csys transforms (..., 4, 4) from two (..., 2, 3) point-pair axes
    (z from vec_z, a provisional x from vec_y, y = x × z, x
    re-orthogonalized, reflection fixed by negating x, then inverted)."""
    pos = vec_z.mean(dim=-2)
    z_hat = unit_vector(vec_z[..., 0, :], vec_z[..., 1, :])
    x_hat = unit_vector(vec_y[..., 0, :], vec_y[..., 1, :])

    y_hat = torch.linalg.cross(x_hat, z_hat)
    y_hat = y_hat / _norm(y_hat)
    x_hat = torch.linalg.cross(y_hat, z_hat)
    x_hat = x_hat / _norm(x_hat)

    transform = _last_row(torch.stack([x_hat, y_hat, z_hat, pos], dim=-1))
    det = torch.linalg.det(transform)
    flip = torch.where(torch.round(det) == -1.0, -1.0, 1.0)
    transform = torch.cat([transform[..., :1] * flip[..., None, None],
                           transform[..., 1:]], dim=-1)
    return inv_transform(transform)


def unitxyz_to_spherical(xyz):
    """[r, theta_deg, phi_deg] along the last axis: theta the azimuth in
    the xy plane, phi the polar angle from +z."""
    r = torch.sqrt(torch.sum(xyz**2, dim=-1))
    theta = torch.atan2(xyz[..., 1], xyz[..., 0])
    phi = torch.arccos(xyz[..., 2] / r)
    return torch.stack([r, torch.rad2deg(theta), torch.rad2deg(phi)], dim=-1)


def spherical_to_unitxyz(sphr):
    """Inverse of unitxyz_to_spherical: [r, theta_deg, phi_deg] -> xyz."""
    theta = torch.deg2rad(sphr[..., 1])
    phi = torch.deg2rad(sphr[..., 2])
    r = sphr[..., 0]
    return torch.stack([r * torch.sin(phi) * torch.cos(theta),
                        r * torch.sin(phi) * torch.sin(theta),
                        r * torch.cos(phi)], dim=-1)


def plane_transform(origin, normal):
    """4x4 transforms (..., 4, 4) carrying points on the planes (origin,
    normal), each (..., 3), to z=0."""
    normal = normal / _norm(normal)
    eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
    axis = torch.argmin(torch.abs(normal), dim=-1)
    helper = eye.index_select(0, axis.reshape(-1)).reshape(normal.shape)
    x = torch.linalg.cross(helper, normal)
    x = x / _norm(x)
    y = torch.linalg.cross(normal, x)
    rot = torch.stack([x, y, normal], dim=-2)
    t = -rot @ origin[..., None]
    return _last_row(torch.cat([rot, t], dim=-1))


def transform_plane(point, normal, transform):
    """Transform planes given as (point, normal), each (..., 3); returns
    (point, normal)."""
    point = transform_pts(point[..., None, :], transform)[..., 0, :]
    normal = (transform[..., :3, :3] @ normal[..., None])[..., 0]
    return point, normal
