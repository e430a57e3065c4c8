"""Host-clock time of each host-ingest stage, taken by wrapping the
port's module attributes (a copy of chip_smoke.py's ingest_split and
INGEST_STAGES): within the block, each call of a stage is timed into
sink[stage] (seconds), from whichever thread makes it."""

from __future__ import annotations

import contextlib
import importlib
import time

# (stage, module under shoulder_tpu_torch, function)
INGEST_STAGES = (
    ("read_weld_adjacency", "io.stl", "load_indexed"),
    ("weld_adjacency", "io.native", "weld_soup"),
    ("obb", "host.obb", "oriented_bounds"),
    ("obb_native_search", "io.native", "min_volume_box_silhouette"),
    ("head_detection", "io.ingest", "_head_end"),
    ("presort", "io.ingest", "_presort_faces"),
    ("spec", "io.ingest", "spec_from_arrays"),
)


@contextlib.contextmanager
def ingest_split(sink: dict):
    def timed(fn, key):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sink.setdefault(key, []).append(time.perf_counter() - t0)
        return wrapped

    saved = []
    for key, modname, attr in INGEST_STAGES:
        mod = importlib.import_module(f"shoulder_tpu_torch.{modname}")
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(getattr(mod, attr), key))
    try:
        yield sink
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def ms_per(sink: dict, stages, per: str = "spec") -> float | None:
    """Milliseconds of `stages` per call of the stage `per` (one call of
    spec_from_arrays per ingested bone or volume); None without one."""
    n = len(sink.get(per, []))
    if not n:
        return None
    return 1e3 * sum(sum(sink.get(s, [])) for s in stages) / n
