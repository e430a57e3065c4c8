"""CT bone vs direct mesh, per pose, noise seed and segmentation, on the card.

The PyTorch port's counterpart of tools/eval_ct_pitch.py at chip_smoke.py's
phase-9 setting: each of chip_smoke's four generator bones (CT_POSES) is
rendered at 1.0 mm (CT_SHAPE) with several noise seeds, segmented by the
3D UNet or the HU threshold, meshed by marching tets and run through one
landmark batch at chip_smoke's CT config; its direct analytic mesh runs
at the same config.  Prints each CT bone's differences to its direct mesh
(neck-shaft, retroversion, radius, neck_z), its side and overflow flags,
and the largest |difference| per metric and method: the measurement behind
phase 9's gates.  With --save DIR it also writes the first seed's welded CT
meshes to DIR/ct_<method>_bone<i>.npz (vertices, faces), the input of
tools/compare_ct_meshes_jax.py.

Run (one card):
  python3 tools/eval_ct_poses_torch.py [--seeds 1 11 21]
                                       [--methods unet threshold]
                                       [--save DIR]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

METRICS = ("neckshaft", "retroversion", "radius_curvature", "neck_z")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 11, 21],
                    help="noise seed of the first pose; pose i adds i")
    ap.add_argument("--methods", nargs="+", default=["unet", "threshold"],
                    choices=["unet", "threshold"])
    ap.add_argument("--save", type=Path, default=None,
                    help="directory for the first seed's welded CT meshes")
    args = ap.parse_args()

    from shoulder_tpu_torch.config import DENSE_CONFIG as cfg
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.models import forest, unet
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.pipeline import ct

    print(cs.card())
    dev = torch.device("cuda:0")
    rf, seg2d = forest.load_params(dev), unet.load_model(dev)

    def landmarks(specs):
        return B.landmarks_to_numpy(B.compute_landmarks_batch(
            B.stack_bones(specs, dev), rf, cfg=cfg, seg_model=seg2d))

    direct = []
    for side, rv, ns in cs.CT_POSES:
        v, f = synthetic_humerus(n_rings=220, n_theta=192, side=side,
                                 retroversion_deg=rv, neck_shaft_deg=ns,
                                 **cs.CT_BONE_KW)
        nb, wt = stl.edge_face_adjacency(f)
        direct.append(ingest.spec_from_arrays("direct_mesh", v, f, nb, wt,
                                              config=cfg))
    mesh = landmarks(direct)
    for i, pose in enumerate(cs.CT_POSES):
        print(f"mesh {i} {pose}: " + ", ".join(
            f"{m} {float(getattr(mesh, m)[i]):.3f}" for m in METRICS))

    for method in args.methods:
        worst = dict.fromkeys(METRICS, 0.0)
        for seed in args.seeds:
            specs = []
            for i, (side, rv, ns) in enumerate(cs.CT_POSES):
                vol, origin, spacing = ct.synth_ct_volume(
                    shape=cs.CT_SHAPE, spacing=(cs.CT_PITCH,) * 3,
                    seed=seed + i, noise_hu=15.0, side=side,
                    retroversion_deg=rv, neck_shaft_deg=ns, **cs.CT_BONE_KW)
                seg, iso = ct.segment_volume(vol, method, device=dev)
                specs.append(ct.volume_to_spec(
                    seg, origin, spacing, iso, config=cfg,
                    max_tris=cs.CT_MAX_TRIS, device=dev))
                if args.save is not None and seed == args.seeds[0]:
                    args.save.mkdir(parents=True, exist_ok=True)
                    np.savez_compressed(
                        args.save / f"ct_{method}_bone{i}.npz",
                        vertices=specs[-1].vertices_raw,
                        faces=specs[-1].faces_raw)
            lm = landmarks(specs)
            for i in range(len(specs)):
                d = {m: float(getattr(lm, m)[i]) - float(getattr(mesh, m)[i])
                     for m in METRICS}
                for m in METRICS:
                    worst[m] = max(worst[m], abs(d[m]))
                side_ok = bool(lm.side_is_left[i]) == bool(mesh.side_is_left[i])
                print(f"{method} seed {seed + i} bone {i}: side equal "
                      f"{side_ok}, overflow {bool(lm.qc_slice_overflow[i])}, "
                      + ", ".join(f"d_{m} {d[m]:+.3f}" for m in METRICS),
                      flush=True)
        print(f"{method}: largest |d| " + ", ".join(
            f"{m} {worst[m]:.3f}" for m in METRICS))


if __name__ == "__main__":
    main()
