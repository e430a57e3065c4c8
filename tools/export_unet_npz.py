"""Export the articular UNet checkpoint to the PyTorch port's npz.

Restores the orbax checkpoint shoulder_tpu/models/params/unet/ with the
JAX package (on the CPU) and writes its parameter tree, flattened by key
path ("params/ConvBlock_0/Conv_0/kernel", ...), to
shoulder_tpu_torch/models/params/unet.npz.  The port reads that file
(models/convert.py maps it to a torch state_dict), so machines without
JAX or orbax can run the UNet.

Run:
  python tools/export_unet_npz.py [--out PATH]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "shoulder_tpu_torch"
                    / "models" / "params" / "unet.npz")
    args = ap.parse_args()

    from shoulder_tpu.utils.platform import force_cpu

    force_cpu()
    import jax

    from shoulder_tpu.models import unet_train

    params = unet_train.load_params()
    if params is None:
        raise SystemExit(f"no checkpoint at {unet_train.CKPT_DIR}")
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
        for path, leaf in jax.tree_util.tree_leaves_with_path(params)
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, **flat)
    n = sum(a.size for a in flat.values())
    print(f"wrote {args.out}: {len(flat)} arrays, {n} float32 values")


if __name__ == "__main__":
    main()
