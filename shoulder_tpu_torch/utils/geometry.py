"""Rigid-transform and coordinate-system math (PyTorch).

Port of shoulder_tpu/utils/geometry.py: the same formulas on torch
tensors.  Functions take tensors and return tensors on the same device.
`host_f32` runs one of them on numpy inputs the way the JAX facade does.
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
    s = i/div, so grids match the JAX package to the bit.  `start` and
    `stop` may be 0-d tensors (their device is used) or numbers."""
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=start.device)
    div = num - 1 if endpoint else num
    s = torch.arange(div, dtype=torch.float32, device=start.device) / div
    out = start * (1 - s) + stop * s
    if endpoint:
        out = torch.cat([out, stop.reshape(1)])
    return out


def transform_pts(pts, transform):
    """Apply a 4x4 homogeneous transform to (N,3) points."""
    return pts @ transform[:3, :3].T + transform[:3, 3]


def transform_vecs(vecs, transform):
    """Rotate (N,3) direction vectors by the rotation part of a transform."""
    return vecs @ transform[:3, :3].T


def inv_transform(transform):
    """Invert a rigid 4x4 transform as [R^-1, -R^-1 t] (general 3x3
    inverse, as the reference does)."""
    rot_inv = torch.linalg.inv_ex(transform[:3, :3]).inverse
    t = transform[:3, 3]
    top = torch.cat([rot_inv, (-rot_inv @ t)[:, None]], dim=1)
    last = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                        device=top.device)
    return torch.cat([top, last], dim=0)


def translate_transform(translation):
    """4x4 transform from a 3-vector translation."""
    out = torch.eye(4, dtype=translation.dtype, device=translation.device)
    out[:3, 3] = translation.reshape(3)
    return out


def unit_vector(p1, p2):
    """Unit vector p1 - p2."""
    vec = p1 - p2
    return vec / torch.linalg.vector_norm(vec)


def construct_csys(vec_z, vec_y):
    """CT->csys transform from two 2x3 point-pair axes (z from vec_z, a
    provisional x from vec_y, y = x × z, x re-orthogonalized, reflection
    fixed by negating x, then inverted)."""
    pos = vec_z.mean(dim=0)
    z_hat = unit_vector(vec_z[0], vec_z[1])
    x_hat = unit_vector(vec_y[0], vec_y[1])

    y_hat = torch.linalg.cross(x_hat, z_hat)
    y_hat = y_hat / torch.linalg.vector_norm(y_hat)
    x_hat = torch.linalg.cross(y_hat, z_hat)
    x_hat = x_hat / torch.linalg.vector_norm(x_hat)

    last = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=vec_z.dtype,
                        device=vec_z.device)
    transform = torch.cat(
        [torch.stack([x_hat, y_hat, z_hat, pos], dim=1), last], dim=0
    )
    det = torch.linalg.det(transform)
    flip = torch.where(torch.round(det) == -1.0, -1.0, 1.0)
    transform = torch.cat([transform[:, :1] * flip, transform[:, 1:]], dim=1)
    return inv_transform(transform)


def unitxyz_to_spherical(xyz):
    """[r, theta_deg, phi_deg]: theta the azimuth in the xy plane, phi the
    polar angle from +z."""
    r = torch.sqrt(torch.sum(xyz**2))
    theta = torch.atan2(xyz[1], xyz[0])
    phi = torch.arccos(xyz[2] / r)
    return torch.stack([r, torch.rad2deg(theta), torch.rad2deg(phi)])


def spherical_to_unitxyz(sphr):
    """Inverse of unitxyz_to_spherical: [r, theta_deg, phi_deg] -> xyz."""
    theta = torch.deg2rad(sphr[1])
    phi = torch.deg2rad(sphr[2])
    return torch.stack([sphr[0] * torch.sin(phi) * torch.cos(theta),
                        sphr[0] * torch.sin(phi) * torch.sin(theta),
                        sphr[0] * torch.cos(phi)])


def plane_transform(origin, normal):
    """4x4 transform carrying points on the plane (origin, normal) to z=0."""
    normal = normal / torch.linalg.vector_norm(normal)
    eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
    helper = eye.index_select(0, torch.argmin(torch.abs(normal)).view(1))[0]
    x = torch.linalg.cross(helper, normal)
    x = x / torch.linalg.vector_norm(x)
    y = torch.linalg.cross(normal, x)
    rot = torch.stack([x, y, normal], dim=0)
    t = -rot @ origin
    top = torch.cat([rot, t[:, None]], dim=1)
    last = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype,
                        device=top.device)
    return torch.cat([top, last], dim=0)


def transform_plane(point, normal, transform):
    """Transform a plane given as (point, normal); returns (point, normal)."""
    point = transform_pts(point.reshape(1, 3), transform)[0]
    normal = transform[:3, :3] @ normal.reshape(3)
    return point, normal
