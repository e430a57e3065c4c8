"""The sphere segmenter's kernels on one CUDA card: chip_smoke.py's
phase 4 batch (8 synthetic humeri at DEFAULT_CONFIG with the UNet) with
its sphere_segment call recorded, then phase 5c on that call (each
kernel against its plain version, batch invariance, times and bounds).

    python3 tools/sphere_kernels_torch.py [--out FILE]

Prints ptxas's lines for the two kernels, phase 5c's lines and, last,
one JSON object of phase 5c's results (also written to --out).
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sphere_kernels_torch: needs a CUDA card")
    import chip_smoke
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.models import forest, segment, unet
    from shoulder_tpu_torch.ops import kernels
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.utils import bench

    smi = chip_smoke.card()
    print(f"card: {smi}", flush=True)
    kernels.build()
    for line in kernels.build_log().splitlines():
        if "sphere" in line or ("ptxas info" in line and "Used" in line):
            print(f"  {line.strip()}")
    dev = torch.device("cuda:0")
    specs = []
    with tempfile.TemporaryDirectory() as td:
        for i in range(chip_smoke.BATCH):
            v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                     rng_transform=np.random.default_rng(i))
            path = os.path.join(td, f"bone{i}.stl")
            stl.write_stl(path, v, f)
            specs.append(ingest.load_bone(path))
    rf, seg = forest.load_params(dev), unet.load_model(dev)
    bones = B.stack_bones(specs, dev)
    bench.reset_launches()
    with chip_smoke.recording_kw(segment, "sphere_segment", []) as calls:
        B.compute_landmarks_batch(bones, rf, cfg=DEFAULT_CONFIG,
                                  seg_model=seg)
        torch.cuda.synchronize()
    counts = bench.sphere_launch_counts()
    print(f"sphere launches (score, fit) in one batch: {counts}, expected "
          f"{chip_smoke.sphere_launches(DEFAULT_CONFIG)}", flush=True)
    res = chip_smoke.sphere_phase(calls[0], smi)
    res["launches"] = counts
    res["card"] = smi
    line = json.dumps(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
