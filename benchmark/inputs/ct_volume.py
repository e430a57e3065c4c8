"""CT-like volumes of the synthetic humerus: a frozen copy of the port's
`pipeline/ct.synth_ct_volume`, over the frozen generator beside it."""

from __future__ import annotations

import numpy as np

from benchmark.inputs.humerus import synthetic_humerus


def synth_ct_volume(
    shape=(160, 96, 96),
    spacing=(2.0, 1.6, 1.6),
    bone_hu: float = 700.0,
    tissue_hu: float = 40.0,
    noise_hu: float = 25.0,
    seed: int = 0,
    **bone_kwargs,
):
    """CT-like volume of the synthetic humerus (z = first axis).

    Returns (volume (D,H,W) float32, origin, spacing).  Bone occupancy is
    evaluated from the same analytic radius field the mesh generator uses,
    so the CT path can be validated against the direct-mesh path.
    """
    # sample the generator's surface densely, then rasterize occupancy by
    # radius comparison in polar coordinates per slab
    verts, faces = synthetic_humerus(
        n_rings=220, n_theta=192, **bone_kwargs
    )
    d, h, w = shape
    sz, sy, sx = spacing
    zmin, zmax = verts[:, 2].min() - 4, verts[:, 2].max() + 4
    # center the xy field of view on the bone
    cx, cy = verts[:, 0].mean(), verts[:, 1].mean()
    origin = np.array(
        [cx - (w / 2) * sx, cy - (h / 2) * sy, zmin], np.float64
    )
    zs = origin[2] + np.arange(d) * sz
    ys = origin[1] + np.arange(h) * sy
    xs = origin[0] + np.arange(w) * sx

    # nearest-ring radius lookup from the generator's vertices per ring
    ring_count = 192
    ring_verts = verts[: 220 * ring_count].reshape(220, ring_count, 3)
    ring_zs = ring_verts[:, 0, 2]
    ring_theta = np.arctan2(
        ring_verts[0, :, 1] - cy, ring_verts[0, :, 0] - cx
    )
    # radius field r[ring, theta_idx] about the (cx, cy) axis
    ring_r = np.linalg.norm(
        ring_verts[:, :, :2] - np.array([cx, cy]), axis=2
    )
    order = np.argsort(ring_theta)
    ring_theta_s = ring_theta[order]
    ring_r = ring_r[:, order]

    gx, gy = np.meshgrid(xs - cx, ys - cy)          # (h, w)
    g_r = np.hypot(gx, gy)
    g_th = np.arctan2(gy, gx)
    th_idx = np.clip(
        np.searchsorted(ring_theta_s, g_th), 0, ring_count - 1
    )

    vol = np.full(shape, tissue_hu, np.float32)
    for i, z in enumerate(zs):
        j = np.clip(np.searchsorted(ring_zs, z), 0, 219)
        surf_r = ring_r[j][th_idx]
        inside = g_r <= surf_r
        if ring_zs[0] <= z <= ring_zs[-1]:
            vol[i][inside] = bone_hu
    rng = np.random.default_rng(seed)
    vol += rng.normal(0, noise_hu, shape).astype(np.float32)
    return vol, origin, np.array([sx, sy, sz], np.float64)
