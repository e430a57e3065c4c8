"""Per-bone rows of the JAX package's accuracy-evidence tools: the
reference that the PyTorch twins (tools/eval_articular_torch.py,
tools/eval_arthritic_ab_torch.py) and chip_smoke.py's phase 16 are held
to, bone by bone.

  * tools/eval_articular.py: loaded by path and its run_cohorts(n) called
    (never its main(), which rewrites the committed
    tools/eval_articular_results.json); the rows and flattenings of both
    cohorts, and their summarize() printed beside the committed summary.
  * tools/eval_arthritic_ab.py: it only prints its table, so its cohort
    (default_rng(42), the same draws and redraws) is built again here and
    both arms run through compute_landmarks_batch at DEFAULT_CONFIG, as
    the tool runs them; per bone the truth, each arm's neck-shaft and
    qc_sphere_resid.

Writes tools/eval_articular_rows_jax.json.  With --tiny, the articular
rows alone of one healthy and one arthritic bone at TINY's label grid
and tiny_config(), for the tier-1 comparison, into
tests/eval_articular_tiny_rows_jax.json; the tool's module globals
and shoulder_tpu.config.DEFAULT_CONFIG are set for the call only, in this
process.  Runs on the CPU (a minute or two in all at full size).

    python tools/eval_articular_rows_jax.py [n_per_cohort] [--tiny]
"""

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from shoulder_tpu.utils.platform import force_cpu  # noqa: E402

force_cpu()

import numpy as np  # noqa: E402

OUT = ROOT / "tools" / "eval_articular_rows_jax.json"
TINY_OUT = ROOT / "tests" / "eval_articular_tiny_rows_jax.json"
# the tier-1 comparison's sizes: the label grid (and so the mesh's rings
# and columns), the eval batch and the bones per cohort
TINY = dict(N_RINGS=48, N_THETA=64, BATCH=2, n=1)


def load_tool(name):
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def articular_rows(n, tiny=False):
    """(eval_articular module, its run_cohorts(n) with numpy rows)."""
    import shoulder_tpu.config as C

    E = load_tool("eval_articular")
    if not tiny:
        return E, E.run_cohorts(n)
    saved = (E.N_RINGS, E.N_THETA, E.BATCH, C.DEFAULT_CONFIG)
    E.N_RINGS, E.N_THETA, E.BATCH = (TINY[k] for k in
                                     ("N_RINGS", "N_THETA", "BATCH"))
    C.DEFAULT_CONFIG = C.tiny_config()
    try:
        return E, E.run_cohorts(n)
    finally:
        E.N_RINGS, E.N_THETA, E.BATCH, C.DEFAULT_CONFIG = saved


def ab_cohort(n):
    """tools/eval_arthritic_ab.py's cohort: (BoneSpecs, [(ns, rv)], the
    draw number of each kept bone)."""
    from shoulder_tpu.io import ingest, stl
    from shoulder_tpu.io.testdata import synthetic_humerus

    rng = np.random.default_rng(42)
    specs, truth, draws = [], [], []
    i = 0
    while len(specs) < n:
        i += 1
        ns = float(rng.uniform(125.0, 145.0))
        rv = float(rng.uniform(15.0, 40.0))
        v, f = synthetic_humerus(
            length=float(rng.uniform(250, 310)),
            head_radius=float(rng.uniform(20, 27)),
            neck_shaft_deg=ns,
            retroversion_deg=rv,
            groove_theta_deg=float(rng.uniform(-180, 180)),
            side="left" if rng.random() < 0.5 else "right",
            rng_transform=rng,
            head_flattening=float(rng.uniform(0.12, 0.3)),
            osteophyte_amp=float(rng.uniform(0.5, 2.5)),
            surface_noise=float(rng.uniform(0.2, 0.6)),
        )
        nbr, wt = stl.edge_face_adjacency(f)
        try:
            spec = ingest.spec_from_arrays(
                f"arth{i}", v.astype(np.float32), f.astype(np.int32), nbr, wt
            )
        except ValueError:
            continue
        specs.append(spec)
        truth.append((ns, rv))
        draws.append(i)
    return specs, truth, draws


def ab_rows(n):
    """Per bone of tools/eval_arthritic_ab.py's cohort: the truth, each
    arm's neck-shaft and qc_sphere_resid."""
    from shoulder_tpu.config import DEFAULT_CONFIG
    from shoulder_tpu.pipeline import batch as B

    specs, truth, draws = ab_cohort(n)
    bones = B.stack_bones(specs)
    lm = {}
    for seg in ("sphere", "unet"):
        cfg = dataclasses.replace(DEFAULT_CONFIG, segmenter=seg)
        lm[seg] = B.landmarks_to_numpy(B.compute_landmarks_batch(bones,
                                                                 cfg=cfg))
    return [dict(draw=d, truth_ns=ns, truth_rv=rv,
                 **{f"{seg}_ns": float(lm[seg].neckshaft[i])
                    for seg in lm},
                 **{f"{seg}_resid": float(lm[seg].qc_sphere_resid[i])
                    for seg in lm})
            for i, ((ns, rv), d) in enumerate(zip(truth, draws))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=None)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    n = args.n or (TINY["n"] if args.tiny else 8)
    out_path = TINY_OUT if args.tiny else OUT

    E, results = articular_rows(n, args.tiny)
    summary = E.summarize(results)
    out = {"articular": {kind: {"rows": d["rows"].tolist(),
                                "flattening": d["flattening"].tolist()}
                         for kind, d in results.items()},
           "articular_summary": summary}
    if args.tiny:
        out["tiny"] = TINY
    else:
        committed = json.loads(
            (ROOT / "tools" / "eval_articular_results.json").read_text())
        for name, s in summary.items():
            print(f"\n== {name} (n={s['n']}): fresh, committed, difference")
            for c in E.COLS:
                was = committed.get(name, {}).get(c, float("nan"))
                print(f"  {c:24s} {s[c]:8.3f} {was:8.3f} {s[c] - was:+8.3f}")
        out["ab"] = ab_rows(n)
        for r in out["ab"]:
            print(f"ab draw {r['draw']}: truth {r['truth_ns']:.3f}, sphere "
                  f"{r['sphere_ns']:.3f} (resid {r['sphere_resid']:.3f}), "
                  f"unet {r['unet_ns']:.3f} (resid {r['unet_resid']:.3f})")
    out_path.write_text(json.dumps(out, indent=1))
    print(f"\nwrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
