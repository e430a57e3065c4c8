"""Arthritic-cohort A/B of the PyTorch port: sphere consensus against the
UNet-seeded consensus.  The twin of tools/eval_arthritic_ab.py.

Builds that tool's deterministic synthetic arthritic cohort
(default_rng(42): flattened domes, osteophytes, surface noise, a random
groove angle and a random rigid frame per bone, a degenerate draw
redrawn), runs both segmenters through compute_landmarks_batch at
DEFAULT_CONFIG, and prints the tool's table: per bone the constructed
neck-shaft, each arm's neck-shaft and qc_sphere_resid, then each arm's
|error| mean and max.  Writes the rows to
tools/eval_arthritic_ab_torch_results.json with the card's name and
power limit.  There is no CPU fallback: without a CUDA device it raises
unless `--device cpu` is given.

    python3 tools/eval_arthritic_ab_torch.py [n_bones] [--device cpu]
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ARMS = ("sphere", "unet")
OUT = Path(__file__).resolve().parent / "eval_arthritic_ab_torch_results.json"


def make_cohort(n):
    """The JAX tool's cohort through the port's ingest: (BoneSpecs,
    [(neck-shaft, retroversion)], the draw number of each kept bone)."""
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus

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


def run_arms(specs, device, rf=None, seg_model=None):
    """{arm: numpy Landmarks} of one batch of `specs` per arm on
    `device`, at DEFAULT_CONFIG with the arm's segmenter."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.pipeline import batch as B

    bones = B.stack_bones(specs, device)
    return {seg: B.landmarks_to_numpy(B.compute_landmarks_batch(
        bones, rf, cfg=dataclasses.replace(DEFAULT_CONFIG, segmenter=seg),
        seg_model=seg_model if seg == "unet" else None))
        for seg in ARMS}


def table(truth, draws, out):
    """Print the JAX tool's table; return the per-bone rows."""
    print(f"{'bone':8s} {'truth_ns':>8s} "
          f"{'sph_ns':>8s} {'unet_ns':>8s} {'sph_resid':>9s} {'unet_resid':>10s}")
    rows = []
    for i, ((ns, rv), d) in enumerate(zip(truth, draws)):
        row = dict(draw=d, truth_ns=ns, truth_rv=rv,
                   **{f"{seg}_ns": float(out[seg].neckshaft[i])
                      for seg in ARMS},
                   **{f"{seg}_resid": float(out[seg].qc_sphere_resid[i])
                      for seg in ARMS})
        rows.append(row)
        print(" ".join([f"arth{i:<4d}", f"{ns:8.1f}",
                        *(f"{row[f'{seg}_ns']:8.1f}" for seg in ARMS),
                        f"{row['sphere_resid']:9.2f}",
                        f"{row['unet_resid']:10.2f}"]))
    for seg in ARMS:
        e = np.array([abs(r[f"{seg}_ns"] - r["truth_ns"]) for r in rows])
        print(f"{seg:7s}: neck-shaft |err| mean {np.nanmean(e):.2f} deg, "
              f"max {np.nanmax(e):.2f}, NaN {int(np.isnan(e).sum())}/"
              f"{len(rows)}, mean resid "
              f"{np.nanmean(out[seg].qc_sphere_resid):.2f} mm")
    return rows


def main(argv=None):
    from shoulder_tpu_torch.bone import _device
    from shoulder_tpu_torch.utils import bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = bench.card() if dev.type == "cuda" else "cpu (no card)"
    print(f"card: {card}", flush=True)
    specs, truth, draws = make_cohort(args.n)
    rows = table(truth, draws, run_arms(specs, dev))
    OUT.write_text(json.dumps({"rows": rows, "card": card}, indent=1))
    print(f"\nwrote {OUT} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
