"""Articular-surface UNet over the polar-radius image (PyTorch).

Port of shoulder_tpu/models/unet.py: a 4-level encoder/decoder with skip
connections over the (z, theta) image.  Each conv block is twice a 3x3
conv with zero padding on z and circular padding on theta (the image
wraps at +-pi), GroupNorm(min(8, C)) and tanh-form GELU (Flax's nn.gelu
default).  Downsampling is a 2x2 average pool; upsampling repeats each
pixel 2x2 and applies a 2x2 conv with Flax's SAME padding (0 before, 1
after).  The head is a 1x1 conv; mask = logits > 0.

The convolutions compute in bfloat16 on purpose, as the Flax model does,
each output rounded to bfloat16 once (on a card through `_RoundOnce`);
GroupNorm, GELU and the head run in float32.  As in Flax, the parameters
are float32 and each convolution casts its input, kernel and bias to the
compute dtype inside `forward`, so a gradient reaches the float32
weights (models/unet_train.py trains this form).  For serving,
`serving_` rounds the conv weights to the compute dtype once, which
makes the per-call cast a no-op and gives the same logits bit for bit.

Weights are an npz in the flat Flax layout (models/convert.py): the
shipped models/params/unet.npz (tools/export_unet_npz.py) or one that
models/unet_train.save_params wrote.
"""

from __future__ import annotations

import functools
import math
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shoulder_tpu_torch.models import convert
from shoulder_tpu_torch.pipeline import graphs

DEFAULT_NPZ = Path(__file__).resolve().parent / "params" / "unet.npz"
FEATURES = (16, 32, 64, 128)


def _pad_theta(x):
    """Circular pad of one column on each side of theta (NCHW width)."""
    return torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)


class _RoundOnce(torch.autograd.Function):
    """A reduced-precision convolution whose bias joins the float32
    accumulator, so the output is rounded to the compute dtype once, as
    oneDNN computes it on the CPU and XLA in the JAX package.  cuDNN's
    bf16 convolution rounds its sum to bf16 and PyTorch adds the bias
    after it, a second rounding, 1.3-1.5x the one rounding's error, which
    moved the arthritic cohort's masks by hundreds of pixels and its
    metrics by up to 2.4 degrees (PERF.md).  The forward sums the
    (exactly representable) reduced-precision operands in full float32,
    cuDNN's TF32 off as the package sets it: TF32 tensor cores keep the
    error at one rounding but leave 5x more outputs not correctly
    rounded, enough to move the arthritic cohort's outlier 0.4 degrees
    (PERF.md).  The backward is the reduced-precision convolution's
    own."""

    @staticmethod
    def forward(ctx, conv, x, weight, bias):
        ctx.conv = conv
        ctx.save_for_backward(x, weight)
        return conv._conv_forward(x.float(), weight.float(),
                                  bias.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        c = ctx.conv
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[0]], c.stride, c.padding,
            c.dilation, False, [0] * len(c.stride), c.groups,
            list(ctx.needs_input_grad[1:4]))
        return None, gx, gw, gb


class CastConv:
    """Mixin for a torch conv module that computes in `compute_dtype`
    whatever dtype its parameters rest in: input, weight and bias are
    cast inside forward (differentiably; a cast to the dtype a tensor
    already has is free), and the output has the compute dtype.  Flax's
    nn.Conv(dtype=...).  On a card a reduced compute dtype goes through
    `_RoundOnce`, so the output is rounded once there too."""

    def __init__(self, *args, compute_dtype=torch.bfloat16, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        x, weight, bias = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if x.is_cuda and dt != torch.float32:
            return _RoundOnce.apply(self, x, weight, bias)
        return self._conv_forward(x, weight, bias)


class CastConv2d(CastConv, nn.Conv2d):
    pass


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, features: int,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        kw = dict(padding=(1, 0), compute_dtype=compute_dtype)
        self.conv0 = CastConv2d(c_in, features, 3, **kw)
        self.norm0 = nn.GroupNorm(min(8, features), features, eps=1e-6)
        self.conv1 = CastConv2d(features, features, 3, **kw)
        self.norm1 = nn.GroupNorm(min(8, features), features, eps=1e-6)

    def forward(self, x):
        for conv, norm in ((self.conv0, self.norm0), (self.conv1, self.norm1)):
            x = conv(_pad_theta(x))
            x = norm(x.float())
            x = F.gelu(x, approximate="tanh")
        return x


class UNet(nn.Module):
    """Input (B, 1, H, W) float32 in [0, 1], H and W multiples of
    2^(len(features) - 1); output (B, 1, H, W) float32 logits.

    `compute_dtype` is the dtype the convolutions run in (bfloat16 as the
    Flax model's default; float32 is its `UNet(dtype=jnp.float32)`)."""

    def __init__(self, features=FEATURES, compute_dtype=torch.bfloat16):
        super().__init__()
        features = tuple(features)
        self.features = features
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype)
        enc_in = (1,) + features[:-2]
        self.down = nn.ModuleList(
            [ConvBlock(ci, f, **kw) for ci, f in zip(enc_in, features[:-1])])
        self.mid = ConvBlock(features[-2], features[-1], **kw)
        dec = list(reversed(features[:-1]))
        dec_in = [features[-1]] + dec[:-1]
        self.up_convs = nn.ModuleList(
            [CastConv2d(ci, f, 2, **kw) for ci, f in zip(dec_in, dec)])
        self.up_blocks = nn.ModuleList(
            [ConvBlock(2 * f, f, **kw) for f in dec])
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
            x = up(F.pad(x.to(up.compute_dtype), (0, 1, 0, 1)))
            x = block(torch.cat([x, skip.to(x.dtype)], dim=1))
        return self.head(x.to(self.head.weight.dtype))


def features_of(flat: dict, block: str = "ConvBlock") -> tuple:
    """The widths of the UNet whose flat Flax parameters are `flat`:
    encoder blocks and bottleneck, in order."""
    n_levels = convert.n_levels(flat, block)
    return tuple(int(flat[f"params/{block}_{i}/Conv_0/bias"].shape[0])
                 for i in range(n_levels + 1))


def init_flax_like(model: nn.Module, generator: torch.Generator) -> None:
    """Fill `model` in place as Flax's `model.init` would: every conv
    kernel from lecun_normal (a normal truncated at two standard
    deviations and rescaled to variance 1 / fan_in), every conv bias 0,
    GroupNorm weight 1 and bias 0.  The draws come from `generator` (on
    its device), module by module in registration order; they are not
    JAX's draws, only its distribution."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    # the standard deviation of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                w = mod.weight
                fan_in = w[0].numel()
                u = torch.rand(w.shape, generator=generator,
                               device=generator.device, dtype=torch.float64)
                u = (lo + (hi - lo) * u).clamp_(lo, hi)
                z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
                z = z.clamp_(-2.0, 2.0) / (trunc_std * math.sqrt(fan_in))
                w.copy_(z.to(w.dtype))
                mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


def serving_(model: nn.Module) -> nn.Module:
    """Round every CastConv's parameters to its compute dtype, in place,
    and put the model in eval mode: the serving form, whose per-call
    casts are no-ops.  Not for training: the float32 weights are gone."""
    for mod in model.modules():
        if isinstance(mod, CastConv):
            mod.to(mod.compute_dtype)
    return model.eval()


def model_from_flat(flat: dict, compute_dtype=torch.bfloat16,
                    serving: bool = True) -> UNet:
    """A UNet holding the flat Flax parameters `flat`, at the widths the
    tree has, on the CPU: the serving form by default, else float32
    parameters in train mode."""
    model = UNet(features_of(flat), compute_dtype)
    model.load_state_dict(convert.unet_state_dict(flat))
    return serving_(model) if serving else model


def load_flat(npz_path) -> dict:
    with np.load(npz_path) as z:
        return {k: z[k] for k in z.files}


def load_model(device, npz_path=DEFAULT_NPZ) -> UNet:
    """The UNet of `npz_path` (the shipped one by default) on `device` in
    its serving form: convolutions in bfloat16 except the float32 head,
    eval mode.  Read once per (device, file, size, modification time) per
    process, so a file that training rewrote is read again; callers share
    the model."""
    st = os.stat(npz_path)
    return _load_model(str(torch.device(device)), str(npz_path),
                       st.st_size, st.st_mtime_ns)


@functools.lru_cache(maxsize=8)
def _load_model(device: str, npz_path: str, _size: int, _mtime_ns: int) -> UNet:
    return model_from_flat(load_flat(npz_path)).to(device)


@torch.no_grad()
@graphs.graphed
def segment_image(model: UNet, image):
    """(..., H, W) normalized polar images -> (..., H, W) float {0,1}
    masks, every image of a batch through one forward pass.

    Pads to a multiple of 2^(pooling levels) so the skip connections
    align, then crops back.
    """
    h, w = image.shape[-2:]
    m = 1 << len(model.down)
    x = F.pad(image.reshape(-1, 1, h, w), (0, (-w) % m, 0, (-h) % m))
    logits = model(x)
    return (logits[:, 0, :h, :w] > 0).to(image.dtype).reshape(image.shape)
