"""Does the JAX package still give the committed accuracy rows?

Rebuilds tools/eval_accuracy.py's two cohorts of 8 (default_rng(2026)),
runs the JAX package at DEFAULT_CONFIG on the CPU, and prints, per bone,
its neck-shaft, retroversion and radius beside the row committed in
tools/eval_accuracy_results.json and their difference.  It writes
nothing: the committed rows are what chip_smoke.py's accuracy phase holds
the PyTorch port to, so they must still be the JAX package's.

Run:  python tools/check_accuracy_rows_jax.py   (a few minutes on a CPU)
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import eval_accuracy as E  # noqa: E402  (forces the JAX CPU backend)
import numpy as np  # noqa: E402


def main():
    rows = json.loads(
        (Path(__file__).parent / "eval_accuracy_results.json").read_text())
    rng = np.random.default_rng(2026)
    worst = np.zeros(3)
    for name, arthritic in (("healthy", False), ("arthritic", True)):
        specs, _truth = E.make_cohort(len(rows[name]["rows"]), rng, arthritic)
        lm = E.run_cohort(specs)
        for i, row in enumerate(rows[name]["rows"]):
            got = np.array([lm.neckshaft[i], lm.retroversion[i],
                            lm.radius_curvature[i]], np.float64)
            want = np.array([row["ns"], row["rv"], row["r"]])
            worst = np.maximum(worst, np.abs(got - want))
            print(f"{name} b{i}: (ns, rv, r) {np.round(got, 5)} committed "
                  f"{np.round(want, 5)} diff {got - want}")
    print(f"largest |diff| (ns deg, rv deg, r mm): {worst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
