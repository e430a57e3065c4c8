"""shoulder_tpu_torch: the PyTorch / CUDA port of shoulder_tpu.

The same landmark pipeline as the JAX package `shoulder_tpu` (STL in,
anatomic landmarks and clinical metrics out), written in PyTorch for one
NVIDIA H100.  Module names mirror the JAX package so each module's
counterpart is easy to find.  The one Pallas TPU kernel of the main path,
the contour-chain walk, is a hand-written CUDA kernel here
(csrc/chain_walk.cu, ops/chain_walk.py), and on the main path it runs
inside the fused slice-stack kernel (csrc/slice_stack.cu, one launch per
slice stack for a whole bone batch, ops/slicing.py).  A bone batch runs
as one program on a leading bone dimension, as the JAX package's vmap
makes it (pipeline/landmarks.py), and parallel/mesh.py splits a batch
over devices.

The public API is the JAX package's: `Humerus`, `ProximalHumerus`,
`HumeralHeadOsteotomy`, `Plot` (imported lazily) and
`cohort.process_cohort`, each with one more keyword, `device` (default
"cuda").

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

__version__ = "0.2.0"
__all__ = ["Humerus", "ProximalHumerus", "Plot", "HumeralHeadOsteotomy"]

_EXPORTS = {
    "Humerus": "shoulder_tpu_torch.bone",
    "ProximalHumerus": "shoulder_tpu_torch.bone",
    "HumeralHeadOsteotomy": "shoulder_tpu_torch.arthroplasty",
    "Plot": "shoulder_tpu_torch.plotting",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(name)
