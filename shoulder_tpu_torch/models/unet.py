"""Articular-surface UNet over the polar-radius image (PyTorch).

Port of shoulder_tpu/models/unet.py: a 4-level encoder/decoder with skip
connections over the (z, theta) image.  Each conv block is twice a 3x3
conv with zero padding on z and circular padding on theta (the image
wraps at +-pi), GroupNorm(min(8, C)) and tanh-form GELU (Flax's nn.gelu
default).  Downsampling is a 2x2 average pool; upsampling repeats each
pixel 2x2 and applies a 2x2 conv with Flax's SAME padding (0 before, 1
after).  The head is a 1x1 conv; mask = logits > 0.

The convolutions compute in bfloat16 on purpose, as the Flax model does;
GroupNorm, GELU and the head run in float32.  Weights are the JAX
package's checkpoint, exported to models/params/unet.npz
(tools/export_unet_npz.py) and mapped by models/convert.py.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shoulder_tpu_torch.models import convert

DEFAULT_NPZ = Path(__file__).resolve().parent / "params" / "unet.npz"
FEATURES = (16, 32, 64, 128)


def _pad_theta(x):
    """Circular pad of one column on each side of theta (NCHW width)."""
    return torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(c_in, features, 3, padding=(1, 0))
        self.norm0 = nn.GroupNorm(min(8, features), features, eps=1e-6)
        self.conv1 = nn.Conv2d(features, features, 3, padding=(1, 0))
        self.norm1 = nn.GroupNorm(min(8, features), features, eps=1e-6)

    def forward(self, x):
        for conv, norm in ((self.conv0, self.norm0), (self.conv1, self.norm1)):
            x = conv(_pad_theta(x).to(conv.weight.dtype))
            x = norm(x.float())
            x = F.gelu(x, approximate="tanh")
        return x


class UNet(nn.Module):
    """Input (B, 1, H, W) float32 in [0, 1], H and W multiples of 8;
    output (B, 1, H, W) logits."""

    def __init__(self):
        super().__init__()
        features = FEATURES
        enc_in = (1,) + tuple(features[:-2])
        self.down = nn.ModuleList(
            [ConvBlock(ci, f) for ci, f in zip(enc_in, features[:-1])])
        self.mid = ConvBlock(features[-2], features[-1])
        dec = list(reversed(features[:-1]))
        dec_in = [features[-1]] + dec[:-1]
        self.up_convs = nn.ModuleList(
            [nn.Conv2d(ci, f, 2) for ci, f in zip(dec_in, dec)])
        self.up_blocks = nn.ModuleList([ConvBlock(2 * f, f) for f in dec])
        self.head = nn.Conv2d(features[0], 1, 1)

    def forward(self, x):
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.avg_pool2d(x, 2)
        x = self.mid(x)
        for up, block, skip in zip(self.up_convs, self.up_blocks,
                                   reversed(skips)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = up(F.pad(x.to(up.weight.dtype), (0, 1, 0, 1)))
            x = block(torch.cat([x, skip.to(x.dtype)], dim=1))
        return self.head(x.to(self.head.weight.dtype))


def load_model(device, npz_path=DEFAULT_NPZ) -> UNet:
    """The shipped UNet on `device`, convolutions in bfloat16 except the
    float32 head, in eval mode.  Read once per (device, file) per
    process; callers share the model."""
    return _load_model(str(torch.device(device)), str(npz_path))


@functools.lru_cache(maxsize=None)
def _load_model(device: str, npz_path: str) -> UNet:
    with np.load(npz_path) as z:
        flat = {k: z[k] for k in z.files}
    model = UNet()
    model.load_state_dict(convert.unet_state_dict(flat))
    for block in [*model.down, model.mid, *model.up_blocks]:
        block.conv0.to(torch.bfloat16)
        block.conv1.to(torch.bfloat16)
    model.up_convs.to(torch.bfloat16)
    return model.to(device).eval()


@torch.no_grad()
def segment_image(model: UNet, image):
    """(H, W) normalized polar image -> (H, W) float {0,1} mask.

    Pads to a multiple of 2^(pooling levels) so the skip connections
    align, then crops back.
    """
    h, w = image.shape
    m = 1 << len(model.down)
    x = F.pad(image, (0, (-w) % m, 0, (-h) % m))
    logits = model(x[None, None])
    return (logits[0, 0, :h, :w] > 0).to(image.dtype)
