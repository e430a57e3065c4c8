"""The CT front end of the port's pipeline/ct.py (segment_volume with the
3D UNet, volume_to_spec's surface), plain: the 3D UNet and marching tets
in plain PyTorch on the volume's device, the valid triangles copied to
the host; the weld and ingest are numpy (io/stl.py, io/ingest.py)."""

from __future__ import annotations

import torch

from benchmark.reference.frozen.models import ct_unet
from benchmark.reference.frozen.ops import marching_tets


def segment_volume(volume, model, device):
    """(3D UNet logits on `device`, iso 0)."""
    vol = torch.as_tensor(volume, dtype=torch.float32, device=device)
    return ct_unet.apply_volume(model, vol), 0.0


def surface(volume, origin, spacing, iso: float, max_tris: int = 393216):
    """The marching-tets triangles (n, 3, 3) float32 on the host."""
    soup = marching_tets.marching_tets(
        volume, iso, origin=tuple(float(x) for x in origin),
        spacing=tuple(float(s) for s in spacing), max_tris=max_tris)
    n = int(soup.count)
    return soup.triangles[:n].cpu().numpy()
