"""Export a UNet checkpoint of the JAX package to the PyTorch port's npz.

Restores an orbax checkpoint with the JAX package (on the CPU) and writes
its parameter tree, flattened by key path ("params/ConvBlock_0/Conv_0/
kernel", ...), to an npz under shoulder_tpu_torch/models/params/.  The
port reads that file (models/convert.py maps it to a torch state_dict),
so machines without JAX or orbax can run the model.

  --model unet     the articular UNet, shoulder_tpu/models/params/unet/
                   -> shoulder_tpu_torch/models/params/unet.npz
  --model ct_unet  the CT 3D UNet, shoulder_tpu/models/params/ct_unet/
                   -> shoulder_tpu_torch/models/params/ct_unet.npz

Run:
  python tools/export_unet_npz.py [--model {unet,ct_unet}] [--out PATH]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np

PARAMS = ROOT / "shoulder_tpu_torch" / "models" / "params"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("unet", "ct_unet"), default="unet")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    out = args.out or PARAMS / f"{args.model}.npz"

    from shoulder_tpu.utils.platform import force_cpu

    force_cpu()
    import jax

    if args.model == "unet":
        from shoulder_tpu.models import unet_train as source
    else:
        from shoulder_tpu.models import ct_unet as source

    params = source.load_params()
    if params is None:
        raise SystemExit(f"no checkpoint at {source.CKPT_DIR}")
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
        for path, leaf in jax.tree_util.tree_leaves_with_path(params)
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flat)
    n = sum(a.size for a in flat.values())
    print(f"wrote {out}: {len(flat)} arrays, {n} float32 values")


if __name__ == "__main__":
    main()
