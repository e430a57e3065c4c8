"""The cohort's ingest pool on the card's host: `process_cohort` passes
over `mesh_unet.cohort64`'s 64 STL files (drawn from a seed as the
benchmark draws them, batch 8, the configuration's pipeline) with the
pool of ingest threads set to each of several sizes, in turns.

Per size: each pass's wall time and bones/s (host clock; a pass ends in
its last read-back), the main thread's wait for its prefetch a bone
(`cohort.wait_ns` / `cohort.bones_ingested`) and the share of bones whose
ingest overlapped another's (`cohort.ingest_overlap`); then one pass with
the port's spans recorded: the host time of each `cohort.batch` span (the
main thread's dispatch of a chunk's batch, slowed where the pool holds
the GIL), `cohort.wait` and each ingest span, a chunk or a bone.  With
the card's name and power limit, the usable CPUs and the host's CPU.

    python3 tools/cohort_pool_torch.py [--threads 1 2 4 6 7] [--passes 3]
        [--seed N] [--out cohort_pool.json]

Needs a CUDA card: without one it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CELL = "mesh_unet.cohort64"
SPANS = ("cohort.batch", "cohort.wait", "cohort.prefetch", "ingest.read_weld",
         "ingest.spec", "ingest.obb", "ingest.head", "ingest.presort")


def log(msg):
    print(f"[cohort-pool] {msg}", flush=True)


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi failed: {e}"


def one_pass(paths, cfg, batch, device, threads, record=False) -> dict:
    """One process_cohort pass with a pool of `threads`; its time, counters
    and, when `record`, each span's host ms."""
    from shoulder_tpu_torch import cohort
    from shoulder_tpu_torch.utils import trace

    size = cohort._pool_size
    cohort._pool_size = lambda n: threads
    trace.reset(("cohort.wait_ns", "cohort.bones_ingested",
                 "cohort.ingest_overlap"))
    if record:
        trace.reset()
    try:
        with trace.recording() if record else contextlib.nullcontext():
            t0 = time.perf_counter()
            rows = cohort.process_cohort(paths, config=cfg, batch_size=batch,
                                         device=device)
            seconds = time.perf_counter() - t0
    finally:
        cohort._pool_size = size
    bones = trace.counter("cohort.bones_ingested")
    out = {"threads": threads, "seconds": seconds,
           "bones_per_s": len(rows) / seconds,
           "wait_ms_per_bone": trace.counter("cohort.wait_ns") / 1e6 / bones,
           "overlap_share": trace.counter("cohort.ingest_overlap") / bones}
    if record:
        spans: dict = {}
        for s in trace.spans():
            if s.name in SPANS:
                spans.setdefault(s.name, []).append((s.end_ns - s.start_ns)
                                                    / 1e6)
        out["span_ms"] = {k: {"n": len(v), "mean": statistics.fmean(v),
                              "median": statistics.median(v), "sum": sum(v)}
                          for k, v in spans.items()}
        trace.reset()
    return out


def run(paths, cfg, batch, device, sizes, passes) -> dict:
    """A warm-up pass, then `passes` rounds over `sizes` (each round in
    another order), then one recorded pass per size."""
    one_pass(paths, cfg, batch, device, max(sizes))
    timed: dict = {n: [] for n in sizes}
    for r in range(passes):
        order = sizes[r % len(sizes):] + sizes[:r % len(sizes)]
        for n in order:
            p = one_pass(paths, cfg, batch, device, n)
            timed[n].append(p)
            log(f"round {r} threads {n}: {p['seconds']:.3f} s, "
                f"{p['bones_per_s']:.2f} bones/s, wait "
                f"{p['wait_ms_per_bone']:.2f} ms/bone, overlap "
                f"{p['overlap_share']:.3f}")
    recorded = {n: one_pass(paths, cfg, batch, device, n, record=True)
                for n in sizes}
    summary = {}
    for n in sizes:
        rate = [p["bones_per_s"] for p in timed[n]]
        span_ms = recorded[n]["span_ms"]
        summary[n] = {
            "bones_per_s_median": statistics.median(rate),
            "bones_per_s": rate,
            "ms_per_bone_median": 1e3 / statistics.median(rate),
            "wait_ms_per_bone": [p["wait_ms_per_bone"] for p in timed[n]],
            "overlap_share": [p["overlap_share"] for p in timed[n]],
            "batch_span_ms_per_chunk": span_ms["cohort.batch"]["mean"],
            "span_ms": span_ms}
        log(f"threads {n}: median {summary[n]['bones_per_s_median']:.2f} "
            f"bones/s ({summary[n]['ms_per_bone_median']:.2f} ms a bone), "
            f"cohort.batch {summary[n]['batch_span_ms_per_chunk']:.2f} ms a "
            f"chunk, ingest.spec {span_ms['ingest.spec']['mean']:.2f} ms a "
            f"bone, ingest.read_weld "
            f"{span_ms['ingest.read_weld']['mean']:.2f}")
    return summary


def main(argv=None) -> int:
    import numpy
    import scipy
    import torch

    from benchmark.harness import spec as S
    from benchmark.inputs import draw
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.io import native
    from shoulder_tpu_torch.ops import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 6, 7])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=4324000001)
    ap.add_argument("--out", default="cohort_pool.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cohort_pool_torch.py needs a CUDA card")
    bench = S.load_benchmark()
    cell = S.cell(bench, CELL)
    conf = S.config(bench, cell["config"])
    traffic = S.traffic(cell["traffic"])
    cfg = S.pipeline_config(conf, DEFAULT_CONFIG)
    host = {"card": card_name(), "usable_cpus": len(os.sched_getaffinity(0)),
            "cpu": native.host_cpu(), "torch": torch.__version__,
            "numpy": numpy.__version__, "scipy": scipy.__version__}
    log(json.dumps(host))
    kernels.library()
    with tempfile.TemporaryDirectory(prefix="cohort_pool_") as td:
        params = draw.mesh_params(conf["inputs"], args.seed,
                                  int(traffic["distinct"]))
        paths = draw.write_meshes(params, Path(td))
        summary = run(paths, cfg, int(traffic["batch"]), torch.device("cuda"),
                      list(args.threads), args.passes)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"host": host, "seed": args.seed,
                                          "sizes": summary}, indent=1))
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
