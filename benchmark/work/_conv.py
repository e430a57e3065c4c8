"""Operations and bytes of the UNets' convolutions, from the layer
shapes alone: two per multiply-add of every convolution (bias and head
included), at the resolution each level runs at.  Both UNets are the
same encoder/decoder (models/unet.py, models/ct_unet.py): per level a
block of two k^n convolutions (c_in -> f, f -> f), a 2^n average pool,
a bottleneck block, then per level up a 2^n convolution of the repeated
input (c -> f) and a block (2f -> f, f -> f), and a 1^n head (f0 -> 1).
Bytes: the input read once, the logits written once (float32), the
weights read once (bfloat16, the serving form; the head float32)."""

from __future__ import annotations

import math


def unet_work(spatial, features, dims: int, batch: int = 1, k: int = 3):
    """(bytes, operations) of one forward pass over `batch` inputs of
    `spatial` size (padded as the model pads: each axis to a multiple of
    2^(levels - 1)).  features: the encoder widths and the bottleneck's."""
    levels = len(features) - 1
    m = 1 << levels
    sp = [int(math.ceil(s / m) * m) for s in spatial]
    vox = [batch * math.prod(s // (1 << lvl) for s in sp)
           for lvl in range(levels + 1)]
    kk, up = k ** dims, 2 ** dims
    ops, weights = 0, 0

    def conv(n_out_vox, c_in, c_out, kernel):
        nonlocal ops, weights
        ops += 2 * n_out_vox * c_out * c_in * kernel
        weights += c_out * c_in * kernel + c_out

    c = 1
    for lvl, f in enumerate(features[:-1]):
        conv(vox[lvl], c, f, kk)
        conv(vox[lvl], f, f, kk)
        c = f
    conv(vox[levels], c, features[-1], kk)
    conv(vox[levels], features[-1], features[-1], kk)
    c = features[-1]
    for lvl in reversed(range(levels)):
        f = features[lvl]
        conv(vox[lvl], c, f, up)
        conv(vox[lvl], 2 * f, f, kk)
        conv(vox[lvl], f, f, kk)
        c = f
    head_ops = 2 * vox[0] * features[0]
    ops += head_ops
    n_in = batch * math.prod(spatial)
    n_bytes = 4 * n_in + 4 * n_in + 2 * weights + 4 * (features[0] + 1)
    return n_bytes, ops
