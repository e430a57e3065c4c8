"""A NaN trap for the port, the counterpart of the JAX package's
`jax_debug_nans`: every floating-point output of every aten call, and of
every launch of the port's CUDA kernels, is checked for a NaN.

    from shoulder_tpu_torch.utils import nan_trap

    with nan_trap.trap():             # raises NanError at the first site
        lm = batch.compute_landmarks_batch(...)

    with nan_trap.trap(raise_first=False) as t:
        ...
    t.sites                           # every site, in order

A site names the op and the innermost frame of this package that called
it.  The kernels (`ops/kernels.py`) are called through ctypes, past the
dispatcher, so `trap` also wraps `slicing.slice_stack_kernel` and
`slicing.slice_raw_kernel` and checks their outputs after each launch.

Uninitialized memory (the outputs of `aten.empty*` and `new_empty*`) is
not checked but filled with NaN where it is floating point: a slot that
no op or kernel writes and that a later op reads then shows as a site,
where it would otherwise read whatever the allocator left there.  A
program that writes before it reads gives the same bits in and out of
the trap.

Each check waits for the device: run the trap outside any timed or
sync-counted region.
"""

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PACKAGE)
_HERE = os.path.abspath(__file__)


class NanError(FloatingPointError):
    """A NaN appeared in the output of an op or a kernel launch."""


@dataclasses.dataclass(frozen=True)
class Site:
    op: str      # the aten op, or the kernel wrapper
    frame: str   # "file:line in function" of the innermost port frame


def _port_frame() -> str:
    """The innermost frame of this package outside this module."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PACKAGE + os.sep) and path != _HERE:
            rel = os.path.relpath(path, _ROOT)
            return f"{rel}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return "outside shoulder_tpu_torch"


def _has_nan(t: torch.Tensor) -> bool:
    """Whether a floating-point tensor holds a NaN: through numpy where it
    can view the tensor (a CPU float32 or float64 one; on 1e5 elements a
    tenth of the time of torch's isnan and any), else by torch."""
    if (t.device.type == "cpu" and t.dtype in (torch.float32, torch.float64)
            and not t.requires_grad and not t.is_neg()):
        return bool(np.isnan(t.numpy()).any())
    return bool(torch.isnan(t).any())


def _uninitialized(func) -> bool:
    name = func._schema.name.split("::")[-1]
    return name.startswith(("empty", "new_empty"))


class NanTrap(TorchDispatchMode):
    """Checks the floating-point outputs of every aten call; see the
    module's docstring.  `calls` counts the aten calls seen."""

    def __init__(self, raise_first: bool = True):
        super().__init__()
        self.raise_first = raise_first
        self.sites: list[Site] = []
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.calls += 1
        if _uninitialized(func):
            for t in _pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    t.fill_(float("nan"))
        else:
            self.check(str(func), out)
        return out

    def check(self, op: str, out) -> None:
        """Record a site (or raise, with `raise_first`) if a floating-point
        tensor in `out` holds a NaN."""
        for t in _pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and _has_nan(t)):
                site = Site(op, _port_frame())
                self.sites.append(site)
                if self.raise_first:
                    raise NanError(f"NaN from {site.op} at {site.frame}")
                return


@contextlib.contextmanager
def trap(raise_first: bool = True):
    """Within the block, every aten call and every kernel launch runs
    under a `NanTrap`, which the block gets."""
    from shoulder_tpu_torch.ops import slicing

    mode = NanTrap(raise_first)

    def checked(name):
        fn = getattr(slicing, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            with _disable_current_modes():  # the check's own ops unchecked
                mode.check(f"slicing.{name}", out)
            return out
        return fn, wrapped

    saved = [(name, *checked(name))
             for name in ("slice_stack_kernel", "slice_raw_kernel")]
    for name, _, wrapped in saved:
        setattr(slicing, name, wrapped)
    try:
        with mode:
            yield mode
    finally:
        for name, fn, _ in saved:
            setattr(slicing, name, fn)
