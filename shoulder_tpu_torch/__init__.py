"""shoulder_tpu_torch: the PyTorch / CUDA port of shoulder_tpu.

The same landmark pipeline as the JAX package `shoulder_tpu` (STL in,
anatomic landmarks and clinical metrics out), written in PyTorch for one
NVIDIA H100.  Module names mirror the JAX package so each module's
counterpart is easy to find.  The one Pallas TPU kernel of the main path,
the contour-chain walk, is a hand-written CUDA kernel here
(csrc/chain_walk.cu, ops/chain_walk.py).

This package never imports jax, flax, orbax or shoulder_tpu: the machine
with the card has none of them.

Precision mirrors shoulder_tpu's `jax_default_matmul_precision="highest"`:
float32 matmuls and convolutions run in full float32, never TF32.  The
UNet computes in bfloat16 on purpose, as the Flax model does (GroupNorm
and the output head in float32; models/unet.py).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
