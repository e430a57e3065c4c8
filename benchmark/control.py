"""The two readings each limit of `correct` is set between, over every
input a run of the cell makes from a seed, in one process:

- the program's: the cell's timed entry over every input (the loop's own
  set-up and steps; the program repeats its answers bit for bit, so one
  pass gives what a window compares), against the plain reference: the
  lower readings;
- the controls': the plain reference put in the program's place and
  computed a step below the precisions the configuration states
  (reference/runner.CONTROLS), against the reference.  "all", every
  step at once, is the control of `correct`, whose readings are the
  upper ones; "unet" takes only the steps of the float32 sums (TF32)
  and of the UNets' one rounding.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <k>] [--out FILE]

The controls run on the first `--control-seeds` seeds (all by default).
Runs on a CUDA card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import compare  # noqa: E402
from benchmark.harness import spec as S  # noqa: E402
from benchmark.reference.runner import CONTROLS  # noqa: E402


def _summary(verdict: dict) -> dict:
    return {"numbers": {n: v["value"] for n, v in verdict["numbers"].items()},
            "widest": verdict["widest"], "share": verdict["share"]}


def readings(workload: str, seed: int, device, overrides=None,
             program: bool = True, controls=CONTROLS) -> dict:
    """{"program": ..., <control>: ...}, each {"numbers": {number:
    value}, "widest": {entry: gap}, "share": {entry: share}} against the
    reference, over the inputs of the cell's mix drawn from `seed` that
    a run compares."""
    import torch

    from benchmark.harness import main as M

    bench = S.load_benchmark()
    cell = S.cell(bench, workload)
    conf = S.config(bench, cell["config"])
    traffic = S.traffic(cell["traffic"])
    for key, val in (overrides or {}).items():
        if key == "traffic":
            traffic.update(val)
        else:
            conf[key] = val
    out = {}
    with tempfile.TemporaryDirectory(prefix="shoulder_control_") as td:
        cfg = None
        if program:
            from benchmark.harness import programs as P

            if torch.device(device).type == "cuda":
                from shoulder_tpu_torch.ops import kernels
                kernels.library()
            cfg = P.config(conf)
        run = S.loop(traffic["loop"]).Run(conf, traffic, seed, device,
                                            Path(td), cfg)
        answers: list = []
        if program:
            run.setup({})
            i = 0
            while len({k for k, _ in answers}) < run.distinct:
                answers.extend(run.step(i))
                i += 1
        else:
            run.make_inputs()
        keys = M.compared_keys(range(run.distinct), traffic, seed)
        got = {k: run.answer(raw) for k, raw in answers if k in set(keys)}
        answers.clear()
        run.free()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        want = run.reference(keys)
        limits = conf["limits"]
        if program:
            out["program"] = _summary(compare.judge(
                [(k, got[k], want[k]) for k in keys], limits))
        for name in controls:
            ctl = run.reference(keys, control=name)
            out[name] = _summary(compare.judge(
                [(k, ctl[k], want[k]) for k in keys], limits))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    n_control = (len(args.seeds) if args.control_seeds is None
                 else args.control_seeds)
    rows = []
    for j, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed,
               **readings(args.workload, seed, torch.device("cuda:0"),
                          controls=CONTROLS if j < n_control else ()),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
