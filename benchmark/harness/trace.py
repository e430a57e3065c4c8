"""The traced run (`--trace 1`): what the per-layer metrics read.

1. The window's steps run with the profiler off, each host-ingest stage
   timed by the host clock (harness/ingest_split.py): `mfu.*` and the
   ingest metrics read these steps.
2. A short stretch of `profile_steps` steps (the mix's file) runs under
   torch.profiler, with a profiler range around each call into a layer
   of the port, wrapped from outside by module attribute (`RANGES`, after
   tools/profile_torch_batch.py, whose stage list this copies): busy and
   idle time, device time per range and per kernel, launch API calls.
3. Two steps run under `torch.cuda.set_sync_debug_mode("warn")`; the
   synchronizing calls of the second are counted (utils/bench.py's
   count_syncs; the first watched run of a process counts one more).

The port's own kernels (its library, launched through ctypes) are traced
but neither counted as launch API calls nor tied to their host range, so
launches add the wrappers' counters and a piece of work takes its
kernels' device time by name (work/<piece>.py KERNELS).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import warnings

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import ingest_split as IS
from benchmark.work import _model as W

WINDOW = "benchmark.window"
# (module under shoulder_tpu_torch, attribute, range name): the stages of
# pipeline/landmarks.py and the calls into the layers around them
RANGES = (
    ("ops.slicing", "slice_stack_kernel", "slice_stack_kernel"),
    ("ops.slicing", "slice_raw_kernel", "slice_raw_kernel"),
    ("ops.slicing", "sorted_geom", "sorted_geom"),
    ("pipeline.landmarks", "_surgical_neck", "_surgical_neck"),
    ("pipeline.landmarks", "_canal", "_canal"),
    ("pipeline.landmarks", "_groove", "_groove"),
    ("pipeline.landmarks", "_anp_image_points", "_anp_image_points"),
    ("models.unet", "segment_image", "segment_image"),
    ("models.segment", "sphere_segment", "sphere_segment"),
    ("pipeline.landmarks", "_anp_from_mask", "_anp_from_mask"),
    ("pipeline.landmarks", "_transepicondylar", "_transepicondylar"),
    ("pipeline.landmarks", "_metrics", "_metrics"),
    ("pipeline.batch", "stack_bones", "stack_bones"),
    ("pipeline.batch", "landmarks_to_numpy", "landmarks_to_numpy"),
    ("pipeline.ct", "segment_volume", "segment_volume"),
    ("models.ct_unet", "apply_volume", "apply_volume"),
    ("ops.marching_tets", "marching_tets", "marching_tets"),
    ("io.native", "weld_soup", "weld_soup"),
    ("io.ingest", "spec_from_arrays", "spec_from_arrays"),
    ("io.stl", "load_indexed", "load_indexed"),
    ("cohort", "_prep_chunk", "cohort_prefetch"),
    ("cohort", "_summary", "cohort_summary"),
)
# the ranges that models/segment.sphere_segment opens itself while a
# profiler records
INNER_RANGES = ("sphere_segment.score", "sphere_segment.fit",
                "sphere_segment.sigma", "sphere_segment.rim")
RANGE_NAMES = frozenset([r for _, _, r in RANGES] + list(INNER_RANGES)
                        + [WINDOW])


def _ranged(name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def ranges():
    """Each of RANGES wrapped in a profiler range, restored after."""
    saved = []
    for modname, attr, name in RANGES:
        mod = importlib.import_module(f"shoulder_tpu_torch.{modname}")
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, _ranged(name, fn))
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _merged(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, n_steps: int) -> dict:
    """Busy and idle time, device time per kernel and per range, launch
    API calls and the breakdown, over the profiled stretch."""
    events = prof.events()
    win = [e for e in events if e.name == WINDOW
           and e.device_type != torch.autograd.DeviceType.CUDA]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in RANGE_NAMES]
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    merged = _merged([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in merged)
    kernels: dict = {}
    for s, e, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (e - s) / 1e6
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.name in RANGE_NAMES and e.name != WINDOW
            and e.device_type != torch.autograd.DeviceType.CUDA]
    gaps: dict = {}
    t = w0
    for s, e in merged + [[w1, w1]]:
        if s > t:
            mid = 0.5 * (s + t)
            inside = [h for h in host if h[0] <= mid <= h[1]]
            name = (min(inside, key=lambda h: h[1] - h[0])[2] if inside
                    else "host (between ranges)")
            gaps[name] = gaps.get(name, 0.0) + (s - t) / 1e6
        t = max(t, e)
    per_range = {}
    for e in prof.key_averages():
        if e.key in RANGE_NAMES and e.cpu_time_total > 0:
            per_range[e.key] = {"calls": e.count,
                                "host_s": e.cpu_time_total / 1e6,
                                "device_s": e.device_time_total / 1e6}
    launch_api = sum(e.count for e in prof.key_averages()
                     if "LaunchKernel" in e.key)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n_steps, "window_s": (w1 - w0) / 1e6,
            "busy_s": busy_us / 1e6, "kernels": kernels,
            "ranges": per_range, "launch_api": launch_api,
            "breakdown": {"device_ops": [[n[:200], s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in top_gaps]}}


def count_syncs(run_step) -> int:
    """Synchronizing calls of one step, on the second of two steps under
    set_sync_debug_mode("warn") (utils/bench.py's count)."""
    caught = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return sum("synchronizing" in str(w.message) for w in caught)


def traced(run, seconds, answers, traffic) -> dict:
    """Steps 1-3 of the module note; the answers of every step go to
    `answers`."""
    from benchmark.harness import main as M
    from benchmark.harness import programs as P

    split: dict = {}
    with IS.ingest_split(split):
        steps, window_s, i = M.window(run, seconds, sink=answers)
    n_prof = int(traffic["profile_steps"])
    on_card = torch.cuda.is_available()
    with ranges():
        port0 = P.launch_counters()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                for _ in range(n_prof):
                    answers.extend(run.step(i))
                    i += 1
                if on_card:
                    torch.cuda.synchronize()
        port = P.launch_counters() - port0
    summary = summarize(prof, n_prof)
    del prof
    syncs = None
    if on_card:
        state = {"i": i}

        def one():
            answers.extend(run.step(state["i"]))
            state["i"] += 1

        syncs = count_syncs(one)
    return {"steps": steps, "window_s": window_s,
            "step_keys": [run.step_keys(k) for k in range(len(steps))]
            if hasattr(run, "step_keys") else None,
            "prof_step_keys": [run.step_keys(len(steps) + k)
                               for k in range(n_prof)]
            if hasattr(run, "step_keys") else None,
            "ingest": split, "profiled": summary,
            "launches": (summary["launch_api"] + port) / n_prof,
            "syncs": syncs, "busy_s": summary["busy_s"],
            "traced_window_s": summary["window_s"],
            "breakdown": summary["breakdown"]}


def add_work(record: dict, sink) -> None:
    """Each piece's least seconds per step over the window's steps
    (`work_s`) and over the profiled steps (`work_prof_s`), from the
    reference's recorded calls (reference/runner.py WorkSink) and the
    steps' keys; absent where the loop gives no step keys."""
    from benchmark.harness import spec as S

    if sink is None or record.get("step_keys") is None:
        return
    per_key: dict = {}
    for key, calls in sink.calls.items():
        acc = per_key.setdefault(key, {})
        for piece, n_bytes, n_ops in calls:
            prec = S.work_piece(piece).PRECISION
            acc[piece] = acc.get(piece, 0.0) + W.least_s(n_bytes, n_ops, prec)

    def mean_per_step(step_keys):
        tot: dict = {}
        for keys in step_keys:
            for key in keys:
                for piece, s in per_key.get(key, {}).items():
                    tot[piece] = tot.get(piece, 0.0) + s
        return {p: s / len(step_keys) for p, s in tot.items()}

    record["work_s"] = mean_per_step(record["step_keys"])
    record["work_prof_s"] = mean_per_step(record["prof_step_keys"])


def piece_device_s(record: dict, piece: str) -> float | None:
    """A piece's device seconds per profiled step: its ranges' device time
    and its kernels' by name; None where the trace holds none."""
    from benchmark.harness import spec as S

    mod = S.work_piece(piece)
    prof = record["profiled"]
    total = sum(prof["ranges"][r]["device_s"] for r in mod.RANGES
                if r in prof["ranges"])
    total += sum(s for name, s in prof["kernels"].items()
                 if any(f"::{k}" in name or name.startswith(k)
                        for k in mod.KERNELS))
    return total / prof["steps"] if total > 0 else None

