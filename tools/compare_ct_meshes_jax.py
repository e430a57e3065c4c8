"""CT meshes from the card through the JAX package and the port, on the CPU.

Takes the welded 1.0 mm CT meshes that tools/eval_ct_poses_torch.py --save
wrote (ct_<method>_bone<i>.npz, chip_smoke.py's phase-9 bones) and runs
each, beside the direct analytic mesh of the same generator bone, through
the JAX package's and the port's landmark pipelines on the CPU, at
tools/eval_ct_pitch.py's config (--config tiny: tiny_config widths with
the CT mesh sizes, max_faces 300,000, band 6144, k 1024) or at
the port's DENSE_CONFIG (--config default: DEFAULT_CONFIG's widths
and UNet segmenter with the same sizes).  Prints per bone both
packages' metrics, the port's difference to JAX on the same mesh, and each
package's CT-vs-direct-mesh difference: whether an offset of a CT bone
from its direct mesh is the reference's own or the port's.

Run (CPU, needs the JAX package):
  python tools/compare_ct_meshes_jax.py DIR [--bones 1 2] [--method unet]
                                        [--config {tiny,default}]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from shoulder_tpu.utils.platform import force_cpu  # noqa: E402

force_cpu()

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

METRICS = ("neckshaft", "retroversion", "radius_curvature", "neck_z")


def ct_config(config_module, which):
    """For either package: tools/eval_ct_pitch.py's make_cfg ("tiny") or
    the port's DENSE_CONFIG ("default")."""
    if which == "default":
        from shoulder_tpu_torch.config import DENSE_CONFIG

        fields = {f.name: getattr(DENSE_CONFIG, f.name)
                  for f in dataclasses.fields(DENSE_CONFIG)}
        for name in ("full", "proximal", "distal"):
            fields[name] = config_module.SliceSetConfig(
                **dataclasses.asdict(fields[name]))
        return config_module.PipelineConfig(**fields)
    slice_cfg = config_module.SliceSetConfig
    return dataclasses.replace(
        config_module.tiny_config(max_faces=300000, max_verts=160000),
        full=slice_cfg(zslice_num=64, interp_num=64, band=6144),
        proximal=slice_cfg(zslice_num=96, interp_num=128, band=6144),
        distal=slice_cfg(zslice_num=48, interp_num=96, band=6144),
        max_chain=1024, slice_compact_k=1024)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", type=Path)
    ap.add_argument("--bones", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--method", default="unet")
    ap.add_argument("--config", choices=("tiny", "default"), default="tiny")
    args = ap.parse_args()

    from shoulder_tpu import config as jconfig
    from shoulder_tpu.io import ingest as jingest
    from shoulder_tpu.io import stl as jstl
    from shoulder_tpu.pipeline import batch as JB
    from shoulder_tpu_torch import config as tconfig
    from shoulder_tpu_torch.io import ingest as tingest
    from shoulder_tpu_torch.io import stl as tstl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.pipeline import batch as TB

    jcfg = ct_config(jconfig, args.config)
    tcfg = ct_config(tconfig, args.config)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)

    meshes = []          # (label, vertices, faces) per bone: CT, then direct
    for i in args.bones:
        side, rv, ns = cs.CT_POSES[i]
        with np.load(args.dir / f"ct_{args.method}_bone{i}.npz") as z:
            meshes.append((f"ct {i}", z["vertices"], z["faces"]))
        v, f = synthetic_humerus(n_rings=220, n_theta=192, side=side,
                                 retroversion_deg=rv, neck_shaft_deg=ns,
                                 **cs.CT_BONE_KW)
        meshes.append((f"mesh {i}", v, f))

    out = {}
    for pkg, ingest, stl, cfg in (("jax", jingest, jstl, jcfg),
                                  ("torch", tingest, tstl, tcfg)):
        specs = []
        for label, v, f in meshes:
            nb, wt = stl.edge_face_adjacency(f)
            specs.append(ingest.spec_from_arrays(label, v, f, nb, wt,
                                                 config=cfg))
        if pkg == "jax":
            lm = JB.compute_landmarks_batch(JB.stack_bones(specs), cfg=cfg,
                                            chunk=16)
            out[pkg] = JB.landmarks_to_numpy(lm)
        else:
            lm = TB.compute_landmarks_batch(TB.stack_bones(specs, "cpu"),
                                            cfg=cfg)
            out[pkg] = TB.landmarks_to_numpy(lm)

    for row, (label, _, _) in enumerate(meshes):
        j, t = out["jax"], out["torch"]
        print(f"{label}: " + ", ".join(
            f"{m} jax {float(getattr(j, m)[row]):.3f} torch "
            f"{float(getattr(t, m)[row]):.3f}" for m in METRICS)
            + f", side left jax {bool(j.side_is_left[row])} torch "
            f"{bool(t.side_is_left[row])}, overflow jax "
            f"{bool(j.qc_slice_overflow[row])} torch "
            f"{bool(t.qc_slice_overflow[row])}", flush=True)
    for k, i in enumerate(args.bones):
        for pkg in ("jax", "torch"):
            lm = out[pkg]
            print(f"bone {i} {pkg}: ct - mesh " + ", ".join(
                f"d_{m} {float(getattr(lm, m)[2 * k]) - float(getattr(lm, m)[2 * k + 1]):+.3f}"
                for m in METRICS))


if __name__ == "__main__":
    main()
