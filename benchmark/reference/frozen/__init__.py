"""A frozen copy of the port's plain path (shoulder_tpu_torch's modules
of the same names, as they stood when the benchmark was written), the
plain reference that `correct` is decided against.

Copied verbatim except where the port chooses a kernel: here every
dispatch takes the plain PyTorch version on any device (slice stacks,
the raw loop, the walk, the sphere passes), the STL read, weld and OBB
search are the numpy versions (the port runs them in its native
library), the weights are always named by path, and the training code is
left out.  Nothing here imports the port, JAX or the JAX package, and a
later change to the port does not move this copy.
"""
