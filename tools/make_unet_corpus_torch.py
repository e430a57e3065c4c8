"""Generate an in-domain training corpus for the articular UNet with the
PyTorch port (the counterpart of tools/make_unet_corpus.py).

Randomized synthetic humeri (shoulder_tpu_torch.io.testdata, including
arthritic deformations) go through the port's ingest and the landmark
pipeline's own stages up to the polar-radius image: the full and the
proximal slice stack (one slice-stack kernel launch each on a card), the
canal fit, the groove stage and the anatomic-neck image build.  The
supervision is generative and exact: bones are built in the identity
frame, so each pixel's 3D point maps analytically to a (ring, theta) cell
of the generator's articular-flag grid, looked up on the device.  Bones
run one by one; each batch of BATCH bones is read back once.

With one seed the bones, their order and the rejections are those of
tools/make_unet_corpus.py (the same numpy stream).

Output .npz: images (N,512,512) float16, masks (N,512,512) uint8.

Run:  python tools/make_unet_corpus_torch.py out.npz [n_bones] [seed]
          [arth_frac] [--device cuda]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from shoulder_tpu_torch.config import DEFAULT_CONFIG
from shoulder_tpu_torch.io import ingest, stl, testdata
from shoulder_tpu_torch.models import forest
from shoulder_tpu_torch.ops import slicing
from shoulder_tpu_torch.pipeline import batch as B
from shoulder_tpu_torch.pipeline import landmarks as L
from shoulder_tpu_torch.utils import geometry as geom

BATCH = 8
N_RINGS, N_THETA = 160, 128


def _random_params(rng, arth_frac: float = 0.5):
    p = dict(
        length=rng.uniform(240.0, 320.0),
        shaft_radius=rng.uniform(9.0, 13.0),
        head_radius=rng.uniform(19.0, 28.0),
        neck_shaft_deg=rng.uniform(120.0, 150.0),
        retroversion_deg=rng.uniform(8.0, 45.0),
        # anatomical groove azimuth (coupled to retroversion, like the
        # generator's default) with +-20 deg jitter: the image roll anchor
        # varies in training without making the bone non-anatomical
        groove_theta_deg=None,
        _groove_jitter=rng.uniform(-20.0, 20.0),
        groove_depth=rng.uniform(1.5, 3.5),
        groove_width_deg=rng.uniform(10.0, 18.0),
        epicondyle_half_width=rng.uniform(24.0, 34.0),
        side=("left" if rng.random() < 0.5 else "right"),
    )
    # a fraction of the corpus carries arthritic deformations; the default
    # 0.5 mixes evenly, a higher arth_frac builds arthritic-weighted
    # corpora (the hard regime for the segmenter)
    if rng.random() < arth_frac:
        p.update(
            head_flattening=rng.uniform(0.0, 0.28),
            osteophyte_amp=rng.uniform(0.0, 2.5),
            surface_noise=rng.uniform(0.0, 0.5),
        )
    return p


def extract_one(bt, label_grid, length, z_top, neck_frac, rf, cfg,
                chunk: int = 150):
    """The pipeline's polar-image build for one bone (the input path of
    landmarks._anatomic_neck) and the generative label lookup, on the
    bone's device: (image, mask), each (R, N).

    The window bottom is set from `neck_frac` (a fraction of the
    build-frame length) instead of the surgical-neck changepoint: on the
    synthetic area curves the changepoint can land inside the dome, which
    would give dome-only images, and the lower mask edge (the thing the
    UNet must learn) would never appear in training.  Randomizing
    neck_frac doubles as window-depth augmentation.
    """
    n_rings, n_theta = label_grid.shape
    verts_obb = geom.transform_pts(bt.verts, bt.obb_transform)
    sg = slicing.sorted_geom(verts_obb, bt.faces, bt.neighbors, bt.face_orig)
    zs_full = geom.linspace(cfg.z_inset * bt.z_max, cfg.z_inset * bt.z_min,
                            cfg.full.zslice_num)
    full = slicing.slice_stack(sg, zs_full, cfg.full.interp_num,
                               cfg.full.band, cfg.slice_compact_k, chunk)
    neck_ct = torch.stack([torch.zeros_like(length), torch.zeros_like(length),
                           neck_frac * length])
    neck_z = geom.transform_pts(neck_ct[None, :], bt.obb_transform)[0, 2]
    zs_prox = geom.linspace(cfg.z_inset * bt.z_max, neck_z,
                            cfg.proximal.zslice_num)
    prox = slicing.slice_stack(sg, zs_prox, cfg.proximal.interp_num,
                               cfg.proximal.band, cfg.slice_compact_k, chunk)
    _, _, canal_axis, _, _ = L._canal(full, bt, False, cfg)
    _, _, bg_theta, _, _ = L._groove(prox, bt, canal_axis, rf, cfg)

    # the pipeline's anatomic-neck polar image build
    image, pts = L._anp_image_points(prox, bg_theta, cfg)

    # identity build frame: pixel -> (ring, theta) grid cell
    pts_ct = geom.transform_pts(pts.reshape(-1, 3),
                                geom.inv_transform(bt.obb_transform))
    z0 = torch.clamp(pts_ct[:, 2], min=0.0).minimum(z_top)
    ring = torch.clamp(
        torch.round(z0 / z_top * (n_rings - 1)).to(torch.int64),
        0, n_rings - 1)
    th = torch.atan2(pts_ct[:, 1], pts_ct[:, 0])
    col = torch.round((th + torch.pi) / (2 * torch.pi) * n_theta).to(
        torch.int64) % n_theta
    mask = label_grid[ring, col].reshape(image.shape)
    return image, mask


def build_corpus(n_bones: int, seed: int = 0, out_path=None,
                 arth_frac: float = 0.5, config=DEFAULT_CONFIG,
                 device="cuda"):
    """(images (n, R, N) float16, masks (n, R, N) uint8) of the first
    `n_bones` bones that extract cleanly, made in batches of BATCH; with
    `out_path`, the corpus so far is also saved after every batch."""
    from shoulder_tpu_torch.bone import _device

    dev = _device(device)
    rf = forest.load_params(dev)

    rng = np.random.default_rng(seed)
    images, masks = [], []
    i = 0
    while len(images) < n_bones:
        specs, extras = [], []
        while len(specs) < BATCH:
            i += 1
            params = _random_params(rng, arth_frac)
            jitter = params.pop("_groove_jitter")
            params["groove_theta_deg"] = (
                320.0 - params["retroversion_deg"] + jitter
            )
            v, f, label = testdata.synthetic_humerus(
                return_head_label=True, n_rings=N_RINGS, n_theta=N_THETA,
                **params,
            )
            nbr, watertight = stl.edge_face_adjacency(f)
            try:
                spec = ingest.spec_from_arrays(
                    f"synth{i}", v.astype(np.float32), f.astype(np.int32),
                    nbr, watertight, config=config,
                )
            except ValueError:
                continue  # exceeds padding; resample
            specs.append(spec)
            grid = (label[: N_RINGS * N_THETA].reshape(N_RINGS, N_THETA)
                    .astype(np.float32))
            z_top = testdata.truth_geometry(
                **{k: v for k, v in params.items()
                   if k in ("length", "head_radius", "neck_shaft_deg",
                            "retroversion_deg", "side")}
            )["z_top"]
            extras.append((grid, np.float32(params["length"]),
                           np.float32(z_top),
                           np.float32(rng.uniform(0.68, 0.86))))
        pairs = [
            extract_one(B.bone_tensors(spec, dev),
                        *(torch.as_tensor(x, device=dev) for x in extra),
                        rf, config)
            for spec, extra in zip(specs, extras)
        ]
        # one readback per batch
        im_b = torch.stack([im for im, _ in pairs]).cpu().numpy()
        mk_b = torch.stack([mk for _, mk in pairs]).cpu().numpy()
        fracs = []
        for im, mk in zip(im_b, mk_b):
            frac = float(mk.mean())
            fracs.append(round(frac, 3))
            if not np.isfinite(im).all() or not (0.05 < frac < 0.95):
                continue  # degenerate extraction; resampled next batch
            images.append(im.astype(np.float16))
            masks.append(mk.astype(np.uint8))
        print(f"[corpus] {len(images)}/{n_bones} fracs={fracs}", flush=True)
        if out_path is not None and images:  # incremental checkpoint
            np.savez_compressed(
                out_path, images=np.stack(images), masks=np.stack(masks)
            )
    images, masks = images[:n_bones], masks[:n_bones]
    return np.stack(images), np.stack(masks)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("n_bones", nargs="?", type=int, default=192)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("arth_frac", nargs="?", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    images, masks = build_corpus(args.n_bones, args.seed, out_path=args.out,
                                 arth_frac=args.arth_frac,
                                 device=args.device)
    np.savez_compressed(args.out, images=images, masks=masks)
    print(f"wrote {args.out}: {images.shape}")


if __name__ == "__main__":
    main()
