"""The surgical-neck raw-loop kernel (csrc/slice_raw.cu) on the card, at
the two shapes the port launches it with, stage by stage; with `--parent`
beside another tree's build of the same kernel, in turns.

    python3 tools/raw_loop_ab_torch.py [--parent DIR] [--pairs 6] [--out FILE]

Shapes: the neck planes of chip_smoke.py's phase 4 batch (8 synthetic
humeri at DEFAULT_CONFIG: k 512, band 2048, max_chain 2048, "central")
and of phase 9's CT batch (4 1.0 mm volumes through the 3D UNet, marching
tets and the weld, at config.DENSE_CONFIG: k 1024, band 6144, max_chain
1024), each recorded from one compute_landmarks_batch.

For each shape: the kernel against the plain composition (n, overflow,
loop and points as chip_smoke.py's phase 5b holds them) and its batched
launch against the bones' own launches bit for bit; its time by CUDA
events (chip_smoke.timed_cuda, 50 launches) and the bound from these
inputs; each stage's microseconds inside a block from the timed build
(`slicing.RAW_STAGES`), the median over the blocks of the last of 50
timed launches.

`--parent DIR`: DIR holds another tree's slice_raw.cu (DIR itself, or
DIR/shoulder_tpu_torch/csrc); the tool builds a copy with every
`slice_raw_` symbol renamed `parent_slice_raw_` into its own library
under the build directory, and then also holds that kernel against the
plain composition, its n, overflow and points equal to this tree's bit
for bit, and times the two in turns (parent, this, this, parent, ...,
`--pairs` pairs), with both stage tables.  Nothing of DIR is imported.

Needs a CUDA card.  Prints one JSON line last and writes it to `--out`.
"""

import argparse
import ctypes
import json
import os
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parent_source(path) -> Path:
    """The slice_raw.cu of another tree: DIR/slice_raw.cu or
    DIR/shoulder_tpu_torch/csrc/slice_raw.cu."""
    path = Path(path)
    for cand in (path / "slice_raw.cu",
                 path / "shoulder_tpu_torch" / "csrc" / "slice_raw.cu"):
        if cand.is_file():
            return cand
    raise FileNotFoundError(f"no slice_raw.cu under {path}")


def renamed_source(text: str) -> str:
    """The source with every slice_raw_ symbol prefixed by parent_."""
    return text.replace("slice_raw_", "parent_slice_raw_")


def parent_library(src: Path):
    """Build the renamed copy of `src` into its own library and return it
    bound under the package's entry-point names (a namespace with
    slice_raw_launch, slice_raw_launch_timed and slice_raw_smem_bytes),
    and its compiler log."""
    from shoulder_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="parent_raw.", dir=kernels.BUILD_DIR))
    (work / "slice_raw.cu").write_text(renamed_source(src.read_text()))
    so = kernels.build(src_dir=work, build_dir=work / "build")
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    ns = types.SimpleNamespace()
    for name, args in (("launch", [ptr] * 11 + [i32] * 7 + [ptr]),
                       ("launch_timed", [ptr] * 12 + [i32] * 7 + [ptr]),
                       ("smem_bytes", [i32, i32, i32])):
        fn = getattr(lib, f"parent_slice_raw_{name}")
        fn.argtypes = args
        fn.restype = ctypes.c_longlong if name == "smem_bytes" else i32
        setattr(ns, f"slice_raw_{name}", fn)
    return ns, so.with_suffix(".log").read_text()


def ptxas_lines(log_text):
    return [ln.strip() for ln in log_text.splitlines()
            if "ptxas info" in ln and ("slice_raw" in ln or "Used" in ln)]


def neck_args(dev, td, rf, seg):
    """Phase 4's batch: its surgical-neck raw-loop call's arguments."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.pipeline import batch as B

    specs = []
    for i, side in enumerate(["left", "right"] * (cs.BATCH // 2)):
        v, f = synthetic_humerus(side=side,
                                 rng_transform=np.random.default_rng(i))
        path = os.path.join(td, f"bone{i}.stl")
        stl.write_stl(path, v, f)
        specs.append(ingest.load_bone(path))
    with cs.recording_raw([]) as raw:
        B.compute_landmarks_batch(B.stack_bones(specs, dev), rf,
                                  cfg=DEFAULT_CONFIG, seg_model=seg)
    torch.cuda.synchronize()
    (args, _out), = raw
    return args


def ct_args(dev, rf, seg):
    """Phase 9's CT batch: its raw-loop call's arguments."""
    from shoulder_tpu_torch.config import DENSE_CONFIG as cfg
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.pipeline import ct

    specs = []
    for i, (side, rv, ns) in enumerate(cs.CT_POSES):
        vol, origin, spacing = ct.synth_ct_volume(
            shape=cs.CT_SHAPE, spacing=(cs.CT_PITCH,) * 3, seed=1 + i,
            noise_hu=15.0, side=side, retroversion_deg=rv, neck_shaft_deg=ns,
            **cs.CT_BONE_KW)
        occ, iso = ct.segment_volume(vol, "unet", device=dev)
        specs.append(ct.volume_to_spec(occ, origin, spacing, iso, config=cfg,
                                       max_tris=cs.CT_MAX_TRIS, device=dev))
    with cs.recording_raw([]) as raw:
        B.compute_landmarks_batch(B.stack_bones(specs, dev), rf, cfg=cfg,
                                  seg_model=seg)
    torch.cuda.synchronize()
    (args, _out), = raw
    return args


def same_result(a, b):
    (la, oa), (lb, ob) = a, b
    return (torch.equal(la.n, lb.n) and torch.equal(oa, ob)
            and torch.equal(la.points, lb.points))


def shape_report(name, args, smi, parent=None, pairs=6):
    """Everything the tool measures at one shape (see the module's
    docstring)."""
    from shoulder_tpu_torch.ops import kernels, slicing

    sg, z, band, max_chain, select, k = args
    got = slicing.slice_raw_kernel(*args)
    cs.raw_per_bone(name, args, got)
    worst, _ = cs.check_raw([(name, args, got)])
    n_bytes, n_ops = cs.raw_work(sg, z, band, k, max_chain)
    bound_ms, bound_by = cs.bound(n_bytes, n_ops)
    res = {"bones": int(z.shape[0]), "band": band, "k": k,
           "max_chain": max_chain, "select": select, "bytes": n_bytes,
           "ops": n_ops, "bound_ms": bound_ms, "bound_by": bound_by,
           "vs_plain": worst,
           "smem_bytes": int(kernels.library().slice_raw_smem_bytes(
               band, k, max_chain))}
    runs = {"this": lambda: slicing.slice_raw_kernel(*args)}
    if parent is not None:
        old = slicing.slice_raw_kernel(*args, lib=parent)
        res["parent_vs_plain"], _ = cs.check_raw([(f"{name}, parent", args,
                                                   old)])
        torch.cuda.synchronize()
        if not same_result(got, old):
            raise AssertionError(f"{name}: n, overflow or points differ "
                                 f"from the parent's kernel")
        res["parent_smem_bytes"] = int(parent.slice_raw_smem_bytes(
            band, k, max_chain))
        runs["parent"] = lambda: slicing.slice_raw_kernel(*args, lib=parent)
    order = ["parent", "this", "this", "parent"] if parent else ["this"] * 2
    times = {key: [] for key in runs}
    for _ in range(pairs):
        for key in order:
            times[key].append(cs.timed_cuda(runs[key], 50))
    res["plain_ms"] = cs.timed_cuda(
        lambda: slicing.slice_raw_banded_plain(*args), 3)
    for key, ts in times.items():
        res[f"{key}_ms"] = ts
        med = float(np.median(ts))
        res[f"{key}_ms_median"] = med
        res[f"{key}_stages"] = cs.raw_stage_breakdown(
            f"{name} ({key})", args, smi,
            lib=parent if key == "parent" else None)
        log(f"{name} ({key}): median {med:.4f} ms (min {min(ts):.4f}, max "
            f"{max(ts):.4f}) over {len(ts)} turns of 50 launches; bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by}, "
            f"{100 * bound_ms / med:.3g} % of it ({smi})")
    log(f"{name}: plain composition {res['plain_ms']:.3f} ms ({smi})")
    return res


def main(argv=None):
    from shoulder_tpu_torch.models import forest, unet
    from shoulder_tpu_torch.ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raw_loop_ab_torch: needs a CUDA card")
    smi = cs.card()
    log(f"card: {smi}")
    dev = torch.device("cuda:0")
    kernels.library()
    out = {"card": smi, "ptxas": ptxas_lines(kernels.build_log())}
    parent = None
    if args.parent:
        parent, plog = parent_library(parent_source(args.parent))
        out["parent_ptxas"] = ptxas_lines(plog)
    for key in ("ptxas", "parent_ptxas"):
        for line in out.get(key, []):
            log(f"{key}: {line}")
    rf, seg = forest.load_params(dev), unet.load_model(dev)
    with tempfile.TemporaryDirectory() as td:
        shapes = {"neck planes": neck_args(dev, td, rf, seg),
                  "ct neck planes": ct_args(dev, rf, seg)}
    out["shapes"] = {name: shape_report(name, a, smi, parent, args.pairs)
                     for name, a in shapes.items()}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
