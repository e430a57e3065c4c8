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
GroupNorm, GELU, the pooling and the head run in float32.  The
parameters are float32 and each convolution casts inside `forward`, as
in models/unet.py; `load_model` serves the form whose conv weights were
rounded to bfloat16 once.  Weights are an npz in the flat Flax layout
(models/convert.py): the shipped models/params/ct_unet.npz
(tools/export_unet_npz.py --model ct_unet) or one that `save_params`
wrote after `train`.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shoulder_tpu_torch.models import convert
from shoulder_tpu_torch.models import unet as unet_mod
from shoulder_tpu_torch.utils import trace

DEFAULT_NPZ = Path(__file__).resolve().parent / "params" / "ct_unet.npz"
FEATURES = (8, 16, 32)
HU_SCALE = 1000.0


class CastConv3d(unet_mod.CastConv, nn.Conv3d):
    """A Conv3d that computes in `compute_dtype` whatever dtype its
    parameters rest in."""


class ConvBlock3D(nn.Module):
    def __init__(self, c_in: int, features: int,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        kw = dict(padding=1, compute_dtype=compute_dtype)
        self.conv0 = CastConv3d(c_in, features, 3, **kw)
        self.norm0 = nn.GroupNorm(min(4, features), features, eps=1e-6)
        self.conv1 = CastConv3d(features, features, 3, **kw)
        self.norm1 = nn.GroupNorm(min(4, features), features, eps=1e-6)

    def forward(self, x):
        for conv, norm in ((self.conv0, self.norm0), (self.conv1, self.norm1)):
            x = conv(x)
            x = norm(x.float())
            x = F.gelu(x, approximate="tanh")
        return x


class CTUNet(nn.Module):
    """Input (B, 1, D, H, W) float32 (HU / HU_SCALE), D, H and W multiples
    of 2^(len(features) - 1); output (B, 1, D, H, W) float32 logits.
    `compute_dtype` is the dtype the convolutions run in."""

    def __init__(self, features=FEATURES, compute_dtype=torch.bfloat16):
        super().__init__()
        features = tuple(features)
        self.features = features
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype)
        enc_in = (1,) + features[:-2]
        self.down = nn.ModuleList(
            [ConvBlock3D(ci, f, **kw) for ci, f in zip(enc_in, features[:-1])])
        self.mid = ConvBlock3D(features[-2], features[-1], **kw)
        dec = list(reversed(features[:-1]))
        dec_in = [features[-1]] + dec[:-1]
        self.up_convs = nn.ModuleList(
            [CastConv3d(ci, f, 2, **kw) for ci, f in zip(dec_in, dec)])
        self.up_blocks = nn.ModuleList(
            [ConvBlock3D(2 * f, f, **kw) for f in dec])
        self.head = nn.Conv3d(features[0], 1, 1)

    def forward(self, x):
        # the Flax model casts its input to the conv dtype first
        x = x.to(self.compute_dtype)
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
            x = up(F.pad(x.to(up.compute_dtype), (0, 1, 0, 1, 0, 1)))
            x = block(torch.cat([x, skip.to(x.dtype)], dim=1))
        return self.head(x.to(self.head.weight.dtype))


def load_model(device, npz_path=DEFAULT_NPZ) -> CTUNet:
    """The CT UNet of `npz_path` (the shipped one by default) on `device`
    in its serving form: convolutions in bfloat16 except the float32
    head, eval mode.  Read once per (device, file, size, modification
    time) per process, so a file that training rewrote is read again;
    callers share the model.  Raises FileNotFoundError when the npz is
    missing."""
    st = os.stat(npz_path)
    return _load_model(str(torch.device(device)), str(npz_path),
                       st.st_size, st.st_mtime_ns)


def model_from_flat(flat: dict, compute_dtype=torch.bfloat16,
                    serving: bool = True) -> CTUNet:
    """A CTUNet holding the flat Flax parameters `flat`, at the widths
    the tree has, on the CPU: the serving form by default (the shipped
    model's dtypes, eval mode), else float32 parameters in train mode."""
    model = CTUNet(unet_mod.features_of(flat, "ConvBlock3D"), compute_dtype)
    model.load_state_dict(convert.ct_unet_state_dict(flat))
    return unet_mod.serving_(model) if serving else model


@functools.lru_cache(maxsize=8)
def _load_model(device: str, npz_path: str, _size: int,
                _mtime_ns: int) -> CTUNet:
    return model_from_flat(unet_mod.load_flat(npz_path)).to(device)


@torch.no_grad()
@trace.spanned("ct.unet3d")
def apply_volume(model: CTUNet, volume):
    """(D, H, W) HU volume tensor -> (D, H, W) float32 bone logits on the
    volume's device: zero-pad each axis to a multiple of 4, crop back."""
    v = volume.to(torch.float32) / HU_SCALE
    d, h, w = v.shape
    vp = F.pad(v, (0, (-w) % 4, 0, (-h) % 4, 0, (-d) % 4))
    return model(vp[None, None])[0, 0, :d, :h, :w]


def train(steps: int = 200, size=(64, 48, 48), lr: float = 1e-3,
          seed: int = 0, log_every: int = 25, init_params=None,
          device="cuda", generator: torch.Generator | None = None):
    """Train on synthetic CT volumes, a fresh volume per step (batch 1,
    plain BCE against `HU > 350`).

    The volumes are numpy's: `np.random.default_rng(seed)` draws each
    step's bone exactly as the JAX package's `train` does, so with one
    seed both see the same volumes.  `generator` draws the initial
    weights only (Flax-like; `init_params`, a flat Flax tree, replaces
    them).  Returns the model and the losses of the logged steps.
    """
    from shoulder_tpu_torch.models import unet_train
    from shoulder_tpu_torch.pipeline.ct import synth_ct_volume

    generator = unet_train.training_generator(generator, seed, device)
    dev = generator.device
    if init_params is not None:
        model = model_from_flat(init_params, serving=False).to(dev)
    else:
        model = CTUNet().to(dev)
        unet_mod.init_flax_like(model, generator)
    optimizer = unet_train.adamw(model, lr)

    rng = np.random.default_rng(seed)
    losses = []
    for i in range(steps):
        vol, _, _ = synth_ct_volume(
            shape=size, spacing=(300.0 / size[0], 1.8, 1.8),
            seed=int(rng.integers(1 << 31)),
            retroversion_deg=float(rng.uniform(10, 40)),
            neck_shaft_deg=float(rng.uniform(125, 145)),
            head_radius=float(rng.uniform(19, 27)),
            side="left" if rng.random() < 0.5 else "right",
        )
        label = (vol > 350.0).astype(np.float32)
        v = torch.as_tensor(vol, device=dev)[None, None] / HU_SCALE
        lab = torch.as_tensor(label, device=dev)[None, None]
        loss = unet_train.train_step(model, optimizer, unet_train.bce_loss,
                                     v, lab)
        if i % log_every == 0:
            losses.append(float(loss))
            print(f"[ct_unet] step {i} loss {losses[-1]:.4f}", flush=True)
    return model, losses


def save_params(model: CTUNet, path) -> None:
    """Write the model's parameters as float32 to the npz `path` in the
    flat Flax layout, which `load_model(device, path)` serves from.
    Models this process has already loaded are forgotten, so the next
    `load_model` reads the new file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        np.savez(fh, **convert.ct_unet_flat_params(model.state_dict()))
    _load_model.cache_clear()


def load_params(path=DEFAULT_NPZ):
    """The flat Flax tree of the npz `path`, or None when it is absent."""
    path = Path(path)
    if not path.exists():
        return None
    return unet_mod.load_flat(path)
