"""End-to-end CT path (PyTorch): volume -> segmentation -> surface ->
landmarks.

Port of shoulder_tpu/pipeline/ct.py:

  1. segment bone from the CT volume on the card: the HU threshold, or
     the 3D UNet (models/ct_unet.py) whose logits are cut at 0,
  2. extract the surface with marching tetrahedra (ops/marching_tets.py)
     on the same device, then copy the valid triangles to the host once,
  3. weld to an indexed mesh on the host with the native ingest
     (io/native.py `weld_soup`: what the JAX package's numpy `stl.weld` and
     `stl.edge_face_adjacency` give, bit for bit), build a BoneSpec
     (io/ingest.py), and run the landmark pipeline (pipeline/batch.py).

A batch of volumes is `[volume_to_spec(...)]` -> `batch.stack_bones` ->
`batch.compute_landmarks_batch`, as tools/eval_ct_pitch.py runs it.

The entry points take one keyword the JAX package does not have,
`device` (default "cuda"): where segmentation, surface extraction and
landmarks run.  There is no CPU fallback: without a card, "cuda" raises.

`synth_ct_volume` renders a CT-like volume of the procedural humerus
from its analytic radius field (numpy; equal to the JAX package's bit for
bit, on the port's copy of io/testdata.py).
"""

from __future__ import annotations

import numpy as np
import torch

from shoulder_tpu_torch.config import PipelineConfig
from shoulder_tpu_torch.io import ingest as ingest_mod
from shoulder_tpu_torch.io import native
from shoulder_tpu_torch.ops import marching_tets
from shoulder_tpu_torch.utils import trace


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
    from shoulder_tpu_torch.io.testdata import synthetic_humerus

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


def segment_volume(volume, method: str = "threshold", iso_hu: float = 300.0,
                   device="cuda"):
    """(occupancy volume on `device`, iso): the volume goes to the device
    once.

    'threshold': the HU volume itself, cut at `iso_hu` (bone is
    radiodense) — the robust default.  'unet': the 3D UNet's logits
    (models/ct_unet.py), cut at 0; raises when its weights are missing.
    """
    from shoulder_tpu_torch.bone import _device

    with trace.span("ct.upload"):
        vol = torch.as_tensor(volume, dtype=torch.float32,
                              device=_device(device))
    if method == "threshold":
        return vol, iso_hu
    if method == "unet":
        from shoulder_tpu_torch.models import ct_unet

        if not ct_unet.DEFAULT_NPZ.exists():
            raise RuntimeError(f"no trained ct_unet weights at "
                               f"{ct_unet.DEFAULT_NPZ}; use threshold")
        return ct_unet.apply_volume(ct_unet.load_model(vol.device), vol), 0.0
    raise ValueError(method)


def volume_to_spec(
    volume,
    origin,
    spacing,
    iso: float,
    config: PipelineConfig | None = None,
    max_tris: int = 393216,
    device="cuda",
):
    """Volume -> marching-tets surface on `device` -> one device-to-host
    copy of the valid triangles -> native weld -> BoneSpec (host), padded
    to `config` or, with none, to the smallest padding that holds it."""
    from shoulder_tpu_torch.bone import _device

    vol = torch.as_tensor(volume, dtype=torch.float32, device=_device(device))
    soup = marching_tets.marching_tets(
        vol,
        iso,
        origin=tuple(float(x) for x in origin),
        spacing=tuple(float(s) for s in spacing),
        max_tris=max_tris,
    )
    with trace.span("ct.download"):
        n = int(soup.count)
        tri = soup.triangles[:n].cpu().numpy()
    with trace.span("ct.weld"):
        verts, faces, neighbors, watertight = native.weld_soup(tri)
    return ingest_mod.spec_from_arrays(
        "ct_volume", verts, faces, neighbors, watertight, config=config
    )


def landmarks_from_volume(volume, origin, spacing, method="threshold",
                          config: PipelineConfig | None = None,
                          device="cuda"):
    """The whole CT path for one volume: (numpy Landmarks, BoneSpec), at
    `config` or, with none, at the padding the mesh takes."""
    from shoulder_tpu_torch.pipeline import batch as B

    seg, iso = segment_volume(volume, method, device=device)
    spec = volume_to_spec(seg, origin, spacing, iso, config=config,
                          device=device)
    bt = B.stack_bones([spec], seg.device)
    lm = B.compute_landmarks_batch(bt, cfg=spec.config)
    return B.landmarks_to_numpy(lm), spec
