"""3D UNet for CT bone segmentation (PyTorch).

Port of the inference half of shoulder_tpu/models/ct_unet.py: a small
encoder/decoder over a normalized CT volume that gives per-voxel bone
logits; marching tetrahedra extracts the surface at iso 0
(pipeline/ct.py).  Layout NCDHW, features (8, 16, 32).  Each conv block
is twice a 3x3x3 zero-padded conv, GroupNorm(min(4, C), eps 1e-6) and
tanh-form GELU (Flax's nn.gelu default).  Downsampling is a 2x2x2
average pool; upsampling repeats each voxel 2x2x2 and applies a 2x2x2
conv with Flax's SAME padding for an even kernel (0 before, 1 after on
each axis).  The decoder concatenates [upsampled, skip] in that order;
the head is a 1x1x1 conv.

The convolutions compute in bfloat16 on purpose, as the Flax model does;
GroupNorm, GELU, the pooling and the head run in float32.  Weights are
the JAX package's orbax checkpoint, exported to models/params/ct_unet.npz
(tools/export_unet_npz.py --model ct_unet) and mapped by
models/convert.py.  Training (the JAX module's `train`) is not ported.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shoulder_tpu_torch.models import convert

DEFAULT_NPZ = Path(__file__).resolve().parent / "params" / "ct_unet.npz"
FEATURES = (8, 16, 32)
HU_SCALE = 1000.0


class ConvBlock3D(nn.Module):
    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.conv0 = nn.Conv3d(c_in, features, 3, padding=1)
        self.norm0 = nn.GroupNorm(min(4, features), features, eps=1e-6)
        self.conv1 = nn.Conv3d(features, features, 3, padding=1)
        self.norm1 = nn.GroupNorm(min(4, features), features, eps=1e-6)

    def forward(self, x):
        for conv, norm in ((self.conv0, self.norm0), (self.conv1, self.norm1)):
            x = conv(x.to(conv.weight.dtype))
            x = norm(x.float())
            x = F.gelu(x, approximate="tanh")
        return x


class CTUNet(nn.Module):
    """Input (B, 1, D, H, W) float32 (HU / HU_SCALE), D, H and W multiples
    of 4; output (B, 1, D, H, W) logits."""

    def __init__(self):
        super().__init__()
        features = FEATURES
        enc_in = (1,) + tuple(features[:-2])
        self.down = nn.ModuleList(
            [ConvBlock3D(ci, f) for ci, f in zip(enc_in, features[:-1])])
        self.mid = ConvBlock3D(features[-2], features[-1])
        dec = list(reversed(features[:-1]))
        dec_in = [features[-1]] + dec[:-1]
        self.up_convs = nn.ModuleList(
            [nn.Conv3d(ci, f, 2) for ci, f in zip(dec_in, dec)])
        self.up_blocks = nn.ModuleList([ConvBlock3D(2 * f, f) for f in dec])
        self.head = nn.Conv3d(features[0], 1, 1)

    def forward(self, x):
        # the Flax model casts its input to the conv dtype first
        x = x.to(self.down[0].conv0.weight.dtype)
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.avg_pool3d(x, 2)
        x = self.mid(x)
        for up, block, skip in zip(self.up_convs, self.up_blocks,
                                   reversed(skips)):
            for dim in (2, 3, 4):
                x = x.repeat_interleave(2, dim=dim)
            x = up(F.pad(x.to(up.weight.dtype), (0, 1, 0, 1, 0, 1)))
            x = block(torch.cat([x, skip.to(x.dtype)], dim=1))
        return self.head(x.to(self.head.weight.dtype))


def load_model(device, npz_path=DEFAULT_NPZ) -> CTUNet:
    """The shipped CT UNet on `device`, convolutions in bfloat16 except
    the float32 head, in eval mode.  Read once per (device, file) per
    process; callers share the model.  Raises FileNotFoundError when the
    npz is missing."""
    return _load_model(str(torch.device(device)), str(npz_path))


def model_from_flat(flat: dict) -> CTUNet:
    """A CTUNet holding the flattened Flax parameters `flat`, with the
    shipped model's dtypes (on the CPU, in eval mode)."""
    model = CTUNet()
    model.load_state_dict(convert.ct_unet_state_dict(flat))
    for block in [*model.down, model.mid, *model.up_blocks]:
        block.conv0.to(torch.bfloat16)
        block.conv1.to(torch.bfloat16)
    model.up_convs.to(torch.bfloat16)
    return model.eval()


@functools.lru_cache(maxsize=None)
def _load_model(device: str, npz_path: str) -> CTUNet:
    with np.load(npz_path) as z:
        flat = {k: z[k] for k in z.files}
    return model_from_flat(flat).to(device)


@torch.no_grad()
def apply_volume(model: CTUNet, volume):
    """(D, H, W) HU volume tensor -> (D, H, W) float32 bone logits on the
    volume's device: zero-pad each axis to a multiple of 4, crop back."""
    v = volume.to(torch.float32) / HU_SCALE
    d, h, w = v.shape
    vp = F.pad(v, (0, (-w) % 4, 0, (-h) % 4, 0, (-d) % 4))
    return model(vp[None, None])[0, 0, :d, :h, :w]
