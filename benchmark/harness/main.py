"""One run of one cell: set-up, the measured window, the check of what
the window produced against the plain reference, the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (`setup_s`) runs from the process's start to the window's start:
imports, the kernel library (built once per checkout into the port's
`_build/`), the inputs drawn from the seed, the models and a warm-up
step over the cell's own shapes.  The window runs the cell's closed
loop for `--seconds`; it ends with the last whole step, and every rate
is taken over all the steps and all the time of the window.  With
`--trace 1` the window is followed by a short profiled stretch and one
step watched for synchronizing calls; the metrics are then the cell's
per-layer metrics (benchmark/metrics).  Then the peak device memory is
read, the program's state freed, and the reference (benchmark/reference)
run over every input the window answered; the numbers compared, each
beside its limit, end standard error and the result line.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from benchmark.harness import compare
from benchmark.harness import spec as S

FORBIDDEN = ("jax", "jaxlib", "flax", "shoulder_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, jaxlib's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def compared_keys(keys, traffic: dict, seed: int) -> list:
    """The inputs whose answers are compared: all, or where the mix sets
    `compare`, a sample of them drawn from the seed (every answer the
    window gave for those is compared)."""
    keys = sorted(keys)
    if "compare" in traffic and traffic["compare"] < len(keys):
        rng = np.random.default_rng([seed & (2**64 - 1), 3])
        keys = sorted(rng.choice(keys, traffic["compare"],
                                 replace=False).tolist())
    return keys


def log_entries(verdict: dict) -> None:
    """Each entry's widest gap and share of answers past compare.JUMP,
    printed and compared only through the numbers."""
    log("each landmark's widest gap / share of answers past "
        f"{compare.JUMP}: " + ", ".join(
            f"{n} {verdict['widest'][n]:.3g} / {verdict['share'][n]:.3g}"
            for n in sorted(verdict["widest"])))


def window(run, seconds: float, first_step: int = 0, sink=None):
    """Run steps until `seconds` have passed; the window ends with the last
    whole step.  Returns (steps [(start, end, answers)], window seconds,
    next step index); answers go to `sink`."""
    import torch

    steps = []
    i = first_step
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        out = run.step(i)
        e = time.perf_counter()
        steps.append((s, e, len(out)))
        if sink is not None:
            sink.extend(out)
        i += 1
        if e - t0 >= seconds:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return steps, steps[-1][1] - t0, i


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, bench: dict | None = None,
             overrides: dict | None = None) -> tuple[dict, bool]:
    """One run on `device`; returns (the result line's object, correct).
    `overrides` (tests only) replaces entries of the configuration file
    ("pipeline", "inputs", "limits") and of the traffic mix."""
    import torch

    bench = bench or S.load_benchmark()
    cell = S.cell(bench, workload)
    conf = S.config(bench, cell["config"])
    traffic = S.traffic(cell["traffic"])
    for key, val in (overrides or {}).items():
        if key == "traffic":
            traffic.update(val)
        else:
            conf[key] = val
    from benchmark.harness import programs as P
    split = {"imports": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        from shoulder_tpu_torch.ops import kernels
        kernels.library()
    split["build"] = time.perf_counter() - t0
    cfg = P.config(conf)
    answers: list = []
    with tempfile.TemporaryDirectory(prefix="shoulder_bench_") as td:
        run = S.loop(traffic["loop"]).Run(conf, traffic, seed, device,
                                            Path(td), cfg)
        run.setup(split)
        setup_s = time.perf_counter() - t_start
        log(f"setup {setup_s:.3f} s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()))
        record = None
        if trace:
            from benchmark.harness import trace as T
            record = T.traced(run, seconds, answers, traffic)
            steps, window_s = record["steps"], record["window_s"]
        else:
            steps, window_s, _ = window(run, seconds, sink=answers)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        else:
            peak = 0
        log(f"window {window_s:.3f} s, {len(steps)} steps, "
            f"{len(answers)} answers")

        keys = compared_keys({k for k, _ in answers}, traffic, seed)
        attempted = len(answers)
        chosen = set(keys)
        got = [(k, run.answer(raw)) for k, raw in answers if k in chosen]
        answers.clear()
        run.free()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sink = None
        if record is not None:
            from benchmark.reference.runner import WorkSink
            sink = WorkSink()
        want = run.reference(keys, sink=sink)
        log(f"reference over {len(keys)} inputs in "
            f"{time.perf_counter() - t0:.1f} s")
        verdict = compare.judge([(k, g, want[k]) for k, g in got],
                                conf["limits"])
        first = {}
        for k, g in got:
            first.setdefault(k, g)
        repeat = compare.judge([(k, g, first[k]) for k, g in got],
                               conf["limits"])["widest"]
        log("the program's answers against its first answer for the same "
            f"input, widest gap: {max(repeat.values(), default=0.0)!r}")
        log_entries(verdict)

    metrics = {}
    if record is None:
        ctx = {"steps": steps, "window_s": window_s, "setup_s": setup_s,
               "unit": run.unit}
        for m in S.end_to_end(bench, workload):
            metrics[m["name"]] = {"value": S.end_to_end_fn(m["name"])(ctx),
                                  "unit": m["unit"]}
    else:
        from benchmark.harness import trace as T
        T.add_work(record, sink)
        for m in S.per_layer(bench, workload):
            reader, arg = S.reader_of(m["name"])
            value = reader.read(record, arg)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if torch.device(device).type == "cuda"
                   else torch.device(device).type,
                   "kind": (torch.cuda.get_device_name(device)
                            if torch.device(device).type == "cuda"
                            else "cpu"),
                   "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": verdict["failed"], "metrics": metrics,
              "device": device_info}
    if record is not None:
        device_info["busy_s"] = record["busy_s"]
        device_info["window_s"] = record["traced_window_s"]
        result["breakdown"] = record["breakdown"]
    for name, (key, where) in verdict["worst"].items():
        log(f"{name} set by: input {key}, {where}")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    result["checks"] = verdict["numbers"]
    for name, v in verdict["numbers"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    return result, verdict["correct"]


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = S.load_benchmark()
    cell = S.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}")
        return 2
    result, _ = run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda:0"), t_start,
                         bench)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
