"""Voxel-pitch sweep of the PyTorch port's CT path: the twin of
tools/eval_ct_pitch.py.

The same synthetic bone (tests/test_ct_path.py's) through (a) its direct
analytic mesh (220 rings of 192) and (b) synth_ct_volume (seed 1, 15 HU
noise, a 320 x 144 x 144 mm field of view) -> a 300 HU threshold ->
marching tets on the device -> the native weld, at each pitch, then one
compute_landmarks_batch of all of them at the JAX tool's config
(tiny_config's stacks with the padded sizes of a 1.0 mm CT mesh: band
6144, k 1024, max_chain 1024; chip_smoke.pitch_config).  Prints the
CT-vs-mesh metric deltas per pitch as the JAX tool does.

Writes tools/eval_ct_pitch_torch_results.json in the JAX tool's layout
(`reference`: the direct mesh's ns, rv, rad, nz; `rows`: pitch_mm, d_ns,
d_rv, d_rad, d_neck_z, side_ok) plus the card's name and power limit
under `card`.  Where the JAX tool pins the CPU, this one runs on the
card; there is no CPU fallback: without a CUDA device it raises unless
`--device cpu` is given.

    python3 tools/eval_ct_pitch_torch.py [pitch_mm ...] [--device cpu] [--out FILE]

(default pitches 1.0 1.5 2.0)
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

OUT = Path(__file__).parent / "eval_ct_pitch_torch_results.json"


def run(pitches, device, cfg=None):
    """(reference, rows) of the sweep on `device`: the direct mesh's
    metrics and each pitch's CT-vs-mesh deltas, keyed as the JAX tool's
    JSON."""
    import chip_smoke
    from shoulder_tpu_torch.models import forest
    from shoulder_tpu_torch.pipeline import batch as B

    cfg = cfg or chip_smoke.pitch_config()
    specs = [chip_smoke.pitch_mesh_spec(cfg)]
    for p in pitches:
        spec = chip_smoke.pitch_ct_spec(p, cfg, device)
        if not spec.watertight:
            raise AssertionError(f"pitch {p}: not watertight")
        specs.append(spec)
    lm = B.landmarks_to_numpy(B.compute_landmarks_batch(
        B.stack_bones(specs, device), forest.load_params(device), cfg=cfg,
        chunk=16))
    ref = dict(ns=float(lm.neckshaft[0]), rv=float(lm.retroversion[0]),
               rad=float(lm.radius_curvature[0]), nz=float(lm.neck_z[0]))
    rows = [dict(pitch_mm=p, **chip_smoke.pitch_deltas(lm, i),
                 side_ok=bool(lm.side_is_left[i] == lm.side_is_left[0]))
            for i, p in enumerate(pitches, start=1)]
    return ref, rows


def main(argv=None):
    from shoulder_tpu_torch.bone import _device
    from shoulder_tpu_torch.utils import bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pitches", nargs="*", type=float,
                    default=[1.0, 1.5, 2.0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = bench.card() if dev.type == "cuda" else "cpu (no card)"
    print(f"card: {card}", flush=True)
    ref, rows = run(args.pitches, dev)
    print(f"\ndirect mesh: ns {ref['ns']:.2f}  rv {ref['rv']:.2f}  "
          f"rad {ref['rad']:.2f}  neck_z {ref['nz']:.2f}")
    print(f"{'pitch':>6s} {'d_ns':>7s} {'d_rv':>7s} {'d_rad':>7s} "
          f"{'d_neckz':>8s} {'side_ok':>8s}")
    for row in rows:
        print(f"{row['pitch_mm']:6.2f} {row['d_ns']:+7.2f} "
              f"{row['d_rv']:+7.2f} {row['d_rad']:+7.2f} "
              f"{row['d_neck_z']:+8.2f} {str(row['side_ok']):>8s}")
    out = Path(args.out)
    out.write_text(json.dumps(dict(reference=ref, rows=rows, card=card),
                              indent=1))
    print(f"\nwrote {out}")
    return ref, rows


if __name__ == "__main__":
    main()
