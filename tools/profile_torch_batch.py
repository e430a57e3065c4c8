"""Profile the PyTorch port's batch pipeline on one CUDA card.

Builds the same 8 synthetic humeri as chip_smoke.py, warms up, then runs
one batch at DEFAULT_CONFIG under torch.profiler with the port's
recorder on (shoulder_tpu_torch/utils/trace.py): each stage of
pipeline/landmarks.py is a span of the program's own, on the profiler's
clock.  Prints the batch wall time, the device's busy and idle share
over it, host time per span and the device time of the PyTorch kernels
launched inside it, the device's idle time by the span the host was in,
the top kernels by device time, and the host's launches and waits; with
--trace, writes the Chrome trace (tens of MB) with the spans merged in.
With --cost N, first times N unprofiled batches with the recorder off
and N with it on, in turns (off-on, on-off, ...), and prints what
recording costs a batch.

The profiler traces the kernels of ops/kernels.py's library on the card
but neither counts their launches as cudaLaunchKernel nor ties them to
the host op that launched them (PyTorch 2.11 on an H100; linking the
library against the shared CUDA runtime did not change that).  So the
launch count adds the wrappers' own counters, and the library's kernels
are listed by name, not under a span.

Run (on a machine with a card):
  python3 tools/profile_torch_batch.py [--batch 8] [--cost N] [--trace PATH]
"""

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from shoulder_tpu_torch.utils import trace

# the library's kernels (csrc/), by the name the trace gives them
OWN_KERNELS = ("slice_stack_kernel", "slice_raw_kernel",
               "chain_walk_kernel", "sphere_score_kernel",
               "sphere_fit_kernel", "sphere_sigma_kernel")
CUDA = torch.autograd.DeviceType.CUDA


def _busy_ms(prof):
    """Union of device kernel and copy intervals (ms): the time the card
    was busy.  Device-side copies of profiler ranges are left out."""
    return sum(e - s for s, e in _intervals(prof)) / 1e3


def _span_ns(n: int = 200_000) -> dict:
    """Host ns of one span, with the recorder off and on, by a loop of
    `n` (the best of 5), beside a bare call."""
    def bare():
        pass

    def with_span():
        with trace.span("cost"):
            pass

    deco = trace.spanned("cost")(bare)

    def best(fn):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            runs.append((time.perf_counter_ns() - t0) / n)
        return min(runs)

    out = {"bare call": best(bare), "with span, off": best(with_span),
           "spanned call, off": best(deco)}
    with trace.recording():
        out["with span, on"] = best(with_span)
        out["spanned call, on"] = best(deco)
    trace.reset()
    return out


def _by_span(prof, spans, busy):
    """Per span name: calls, host ms, and the device ms of the kernels
    launched by the ops that started inside it (innermost span); and the
    device's idle ms between busy intervals by the span the host was in,
    following a wait to its cause (`trace.timeline`)."""
    t_base = prof.profiler.kineto_results.trace_start_ns()
    thread = next(s.thread for s in spans if s.name == "landmarks.batch")
    spans = [s for s in spans if s.thread == thread]
    rows: dict = {}
    for s in spans:
        row = rows.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (s.end_ns - s.start_ns) / 1e6
    pieces = trace.timeline(spans, thread, min(s.start_ns for s in spans),
                         max(s.end_ns for s in spans))
    starts = [p[0] for p in pieces]
    for e in prof.events():
        dev_us = getattr(e, "self_device_time_total", 0)
        if e.device_type == CUDA or dev_us <= 0:
            continue
        t = t_base + int(1000 * e.time_range.start)
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < pieces[i][1]:
            rows[pieces[i][2]][2] += dev_us / 1e3
    ns = [(t_base + int(1000 * s), t_base + int(1000 * e)) for s, e in busy]
    gaps = [(a[1], b[0]) for a, b in zip(ns, ns[1:])]
    return rows, {k: 1e3 * v for k, v in trace.name_gaps(gaps, pieces).items()}


def _intervals(prof):
    """The device's busy intervals (us, merged)."""
    out = []
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if e.device_type == CUDA
                       and not getattr(e, "is_user_annotation", False)):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--trace", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_batch: needs a CUDA card")

    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.models import forest, unet
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.utils import bench

    dev = torch.device("cuda:0")
    specs = []
    with tempfile.TemporaryDirectory() as td:
        for i in range(args.batch):
            v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                     rng_transform=np.random.default_rng(i))
            p = os.path.join(td, f"b{i}.stl")
            stl.write_stl(p, v, f)
            specs.append(ingest.load_bone(p))
    bones = B.stack_bones(specs, dev)
    rf, seg = forest.load_params(dev), unet.load_model(dev)

    def run():
        B.compute_landmarks_batch(bones, rf, seg_model=seg)
        torch.cuda.synchronize()

    def timed():
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        run()
    walls = [timed() for _ in range(5)]
    print("unprofiled batch ms:", ", ".join(f"{w:.1f}" for w in walls))
    if args.cost:
        off, on = [], []
        for k in range(args.cost):
            # off then on, then on then off: neither side always second
            for rec in ((False, True), (True, False))[k % 2]:
                with trace.recording() if rec else contextlib.nullcontext():
                    (on if rec else off).append(timed())
        n_spans = len(trace.spans()) / args.cost
        trace.reset()
        diff = statistics.quantiles([a - b for a, b in zip(on, off)], n=4)
        m_off = statistics.median(off)
        print(f"recorder cost over {args.cost} batches each, in turns: "
              f"median {m_off:.3f} ms off, {statistics.median(on):.3f} ms "
              f"on; paired difference on - off: median {diff[1]:+.3f} ms "
              f"({100 * diff[1] / m_off:+.2f} %), quartiles {diff[0]:+.3f} "
              f"/ {diff[2]:+.3f} ms; {n_spans:.0f} spans a batch")
        per = _span_ns()
        print("one span, ns: " + ", ".join(f"{k} {v:.0f}"
                                           for k, v in per.items())
              + f"; {n_spans:.0f} spans a batch: "
              f"{n_spans * per['with span, on'] / 1e6:.4f} ms on, "
              f"{n_spans * per['with span, off'] / 1e6:.4f} ms off")

    port0 = bench.port_launches()
    with trace.recording():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed()
    port = bench.port_launches() - port0
    spans = trace.spans()
    busy = _intervals(prof)
    busy_ms = sum(e - s for s, e in busy) / 1e3
    print(f"profiled batch of {args.batch}: wall {wall:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall:.3f}")

    rows, idle = _by_span(prof, spans, busy)
    print("\nprogram spans (per batch): calls, host ms, kernel ms of the "
          "PyTorch ops inside (innermost span)")
    for name, (n, host, dev_ms) in sorted(rows.items(),
                                          key=lambda kv: -kv[1][1]):
        print(f"  {name:26s} {n:5d} {host:9.2f} {dev_ms:9.2f}")
    print("device idle ms by the span the host was in:")
    for name, ms in sorted(idle.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:8.2f}  {name}")

    avgs = prof.key_averages()
    kernels = sorted((e for e in avgs if e.device_type == CUDA),
                     key=lambda e: -e.self_device_time_total)
    total_launch = sum(e.count for e in kernels)
    print(f"\ndevice ops: {total_launch} launches, "
          f"{sum(e.self_device_time_total for e in kernels) / 1e3:.1f} ms; "
          f"top 15 by device time")
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x  "
              f"{e.key[:90]}")
    print("the port's own kernels (csrc/), as the trace names them:")
    for e in kernels:
        if any(f"::{k}" in e.key or e.key.startswith(k)
               for k in OWN_KERNELS):
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  "
                  f"{e.key[:90]}")
    syncs = {e.key: e.count for e in avgs if e.key in (
        "aten::_local_scalar_dense", "aten::nonzero", "cudaStreamSynchronize",
        "cudaMemcpyAsync", "cudaLaunchKernel")}
    print(f"\nhost waits and launches: {syncs}")
    n_launch = syncs.get("cudaLaunchKernel", 0)
    print(f"kernel launches per batch of {args.batch}: {n_launch + port} "
          f"({n_launch} cudaLaunchKernel and {port} launches of the port's "
          f"library), {(n_launch + port) / args.batch:.1f} per bone")
    print("top 10 host ops by self CPU time")
    for e in sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  {e.self_cpu_time_total / 1e3:8.2f} ms {e.count:6d}x  "
              f"{e.key[:90]}")
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
        with open(args.trace) as fh:
            doc = json.load(fh)
        doc["traceEvents"].extend(
            trace.chrome_events(int(doc.get("baseTimeNanoseconds", 0))))
        with open(args.trace, "w") as fh:
            json.dump(doc, fh)
        print(f"\ntrace: {args.trace} ({len(spans)} program spans merged)")


if __name__ == "__main__":
    main()
