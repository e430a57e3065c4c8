"""chip_smoke.py's phase 6 alone, on one CUDA card: a batch of 1 and a
batch of 8 at DEFAULT_CONFIG with the UNet, each profiled once (launches,
device busy time, idle share), its synchronizing calls counted, and
timed over warm synchronized runs (p50).

    python3 tools/phase6_torch.py [--tree DIR] [--reps 5]

--tree runs another checkout's package and chip_smoke.py (for example
the parent commit unpacked by `git archive` into a directory that
.gitignore lists), so that two trees are compared on one card in one
call.  The bones are chip_smoke.py's: synthetic humeri from
default_rng(i), sides alternating, through an STL and the native ingest.
Prints each batch's line and, last, one JSON object of both batches.
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    os.chdir(tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase6_torch: needs a CUDA card")
    import chip_smoke
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.models import forest, unet
    from shoulder_tpu_torch.pipeline import batch as B

    smi = chip_smoke.card()
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
    out = {"tree": str(tree), "card": smi}
    for n in (1, chip_smoke.BATCH):
        res = chip_smoke.batch_timing(B.stack_bones(specs[:n], dev), rf, seg,
                                      smi, reps=args.reps)
        out[n] = {key: res[key] for key in
                  ("launches", "syncs", "busy_ms", "idle_share",
                   "profiled_wall_ms", "batch_ms", "p50_ms", "peak_bytes")}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
