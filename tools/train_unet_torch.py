"""Train a UNet with the PyTorch port and write an npz checkpoint that
the port serves from (the counterpart of tools/train_unet.py).

--model unet (default): the articular UNet on one or more .npz corpora
(tools/make_unet_corpus_torch.py or tools/make_unet_corpus.py: synthetic
bones with generative labels), mixed with the procedural polar generator.
Corpora whose file name contains "real" are oversampled by --real-repeat.
--resume starts from the shipped shoulder_tpu_torch/models/params/unet.npz.

--model ct_unet: the CT 3D UNet on synthetic CT volumes, a fresh volume
per step; it takes no corpus.  --resume starts from the shipped
ct_unet.npz.

The checkpoint (--out, required) is an npz in the flat Flax layout:
`unet.load_model(device, out)` / `ct_unet.load_model(device, out)` serve
from it, and the JAX package can read its arrays back into a Flax tree.

Run:
  python tools/train_unet_torch.py corpus.npz [more.npz ...] --out unet.npz \\
      [--steps 3000] [--batch 16] [--lr 3e-4] [--real-repeat 8] \\
      [--frac-procedural 0.25] [--resume] [--device cuda]
  python tools/train_unet_torch.py --model ct_unet --out ct_unet.npz \\
      [--steps 200] [--lr 1e-3] [--resume] [--device cuda]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def load_corpora(paths, real_repeat: int):
    """Concatenated (images, masks) of the corpora, those named *real*
    repeated `real_repeat` times."""
    images, masks = [], []
    for path in paths:
        with np.load(path) as d:
            im, mk = d["images"], d["masks"]
        rep = real_repeat if "real" in Path(path).stem else 1
        images.extend([im] * rep)
        masks.extend([mk] * rep)
        print(f"[data] {path}: {im.shape[0]} pairs x{rep}")
    images, masks = np.concatenate(images), np.concatenate(masks)
    print(f"[data] total {images.shape[0]} pairs")
    return images, masks


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("corpora", nargs="*")
    ap.add_argument("--model", choices=("unet", "ct_unet"), default="unet")
    ap.add_argument("--steps", type=int, default=None,
                    help="default 3000 (unet) or 200 (ct_unet)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=None,
                    help="default 3e-4 (unet) or 1e-3 (ct_unet)")
    ap.add_argument("--real-repeat", type=int, default=8,
                    help="oversampling factor for corpora named *real*")
    ap.add_argument("--frac-procedural", type=float, default=0.25)
    ap.add_argument("--resume", action="store_true",
                    help="fine-tune from the shipped checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    if args.model == "ct_unet":
        from shoulder_tpu_torch.models import ct_unet as trainer

        if args.corpora:
            ap.error("--model ct_unet trains on synthetic volumes and "
                     "takes no corpus")
        init = trainer.load_params() if args.resume else None
        model, losses = trainer.train(
            steps=args.steps or 200, lr=args.lr or 1e-3, seed=args.seed,
            init_params=init, device=args.device)
    else:
        from shoulder_tpu_torch.models import unet_train as trainer

        if not args.corpora:
            ap.error("--model unet needs at least one corpus")
        images, masks = load_corpora(args.corpora, args.real_repeat)
        init = trainer.load_params() if args.resume else None
        model, losses = trainer.train_mixture(
            images, masks, steps=args.steps or 3000, batch=args.batch,
            size=images.shape[-1], lr=args.lr or 3e-4, seed=args.seed,
            frac_procedural=args.frac_procedural, init_params=init,
            device=args.device)
    trainer.save_params(model, args.out)
    print(f"[{args.model}] saved {args.out} (final loss {losses[-1]:.4f})")


if __name__ == "__main__":
    main()
