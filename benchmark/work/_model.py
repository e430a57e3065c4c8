"""The arithmetic of the work model: a call's least time on the card is
the larger of its operations over the peak of its precision and its
bytes over the HBM rate (work/peaks.json, the published peaks of one
H100).  Each piece of work is a file beside this one, with:

- HOOKS: the (frozen-copy module, function) pairs whose calls carry the
  piece's work in the reference (benchmark/reference/frozen), which runs
  the same algorithm on the same inputs as the program;
- PRECISION: the key of its peak in peaks.json;
- work(fn, args, kwargs, result) -> (bytes, operations) of one call of
  the function named fn,
  counted from its inputs and shapes, whatever kernel does it;
- RANGES / KERNELS: the profiler ranges (harness/trace.py) and the
  kernel names (the port's own library, by name) whose device time is
  the piece's, for its roofline share.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def least_s(n_bytes: float, n_ops: float, precision: str) -> float:
    """Seconds the card needs at least: max(bytes / HBM rate, operations
    / the precision's peak)."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"],
               n_ops / PEAKS["ops_per_s"][precision])


def bound(n_bytes, n_ops, precision="fp32"):
    """(ms, "bytes" or "operations"), chip_smoke.py's bound()."""
    t_bytes = n_bytes / PEAKS["hbm_bytes_per_s"]
    t_ops = n_ops / PEAKS["ops_per_s"][precision]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
