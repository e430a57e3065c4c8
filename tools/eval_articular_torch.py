"""Articular-segmentation evaluation of the PyTorch port against the
synthetic generator's exact labels.  The twin of tools/eval_articular.py.

The ground truth is the generator's per-vertex articular flag
(io/testdata.py, return_head_label): bones built in the identity frame
map every polar-image pixel analytically to a (ring, theta) cell of that
label grid.  On deterministic healthy and arthritic cohorts (seeds 11
and 13) the port's own stages run, batched over the bones, and each bone
gives one row of COLS:

  * IoU against the oracle mask of the UNet proposal (after the longest
    cyclic run per row), of the sphere-consensus mask and of the
    UNet-seeded mask,
  * the anatomic-neck plane normal's angle to the constructed normal,
    for both segmenters (deg),
  * the neck-shaft and head-radius errors against the constructed
    parameters, for both segmenters (deg, mm),
  * the constructed neck-shaft angle,

and the summary means each cohort, the arthritic one also split at
flattening >= 0.2.  As the JAX tool does, the eval slices without the
original face ids and at slice_stack's default of 512 slots per plane.

Writes tools/eval_articular_torch_results.json (the JAX tool's summary,
keys and rounding unchanged, the per-bone rows under `rows`, the card's
name and power limit under `card`) and prints a table.  There is no CPU
fallback: without a CUDA device it raises unless `--device cpu` is given.

    python3 tools/eval_articular_torch.py [n_per_cohort] [--device cpu]
"""

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BATCH = 4
N_RINGS, N_THETA = 160, 128
# the JAX tool calls slice_stack without compact_k: its default slots
COMPACT_K = 512
SEEDS = (("healthy", 11), ("arthritic", 13))
OUT = Path(__file__).resolve().parent / "eval_articular_torch_results.json"


def _cohort_params(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        p = dict(
            length=float(rng.uniform(250.0, 310.0)),
            shaft_radius=float(rng.uniform(9.5, 12.5)),
            head_radius=float(rng.uniform(20.0, 27.0)),
            neck_shaft_deg=float(rng.uniform(125.0, 145.0)),
            retroversion_deg=float(rng.uniform(12.0, 40.0)),
            side="left" if rng.random() < 0.5 else "right",
        )
        if kind == "arthritic":
            p.update(
                head_flattening=float(rng.uniform(0.12, 0.3)),
                osteophyte_amp=float(rng.uniform(0.5, 2.5)),
                surface_noise=float(rng.uniform(0.1, 0.5)),
            )
        out.append(p)
    return out


COLS = ["iou_unary", "iou_sphere", "iou_unet", "plane_err_sphere_deg",
        "plane_err_unet_deg", "ns_err_sphere_deg", "ns_err_unet_deg",
        "rad_err_sphere_mm", "rad_err_unet_mm", "ns_oracle_deg"]


def summarize(results):
    out = {}
    for kind, data in results.items():
        rows, flats = data["rows"], data["flattening"]
        subsets = {kind: np.ones(len(rows), bool)}
        if kind == "arthritic":
            subsets["arthritic_flat_ge_0.2"] = flats >= 0.2
        for name, sel in subsets.items():
            r = rows[sel]
            out[name] = {
                "n": int(sel.sum()),
                **{c: round(float(np.nanmean(r[:, i])), 3)
                   for i, c in enumerate(COLS)},
            }
    return out


def cohort_inputs(params, kind, start=0):
    """The bones of `params` (dicts of synthetic_humerus arguments) in
    the identity build frame, through the port's ingest: (BoneSpecs,
    label grids (B, N_RINGS, N_THETA), z_top (B,), n_true (B, 3),
    neck-shaft (B,), head radius (B,), flattening (B,)), as the JAX
    tool builds them."""
    from shoulder_tpu_torch.io import ingest, stl, testdata

    specs, grids, ztops, ntrues, nss, rads, flats = ([] for _ in range(7))
    for i, p in enumerate(params):
        v, f, label = testdata.synthetic_humerus(
            return_head_label=True, n_rings=N_RINGS, n_theta=N_THETA, **p)
        nbr, wt = stl.edge_face_adjacency(f)
        specs.append(ingest.spec_from_arrays(
            f"{kind}{start + i}", v.astype(np.float32), f.astype(np.int32),
            nbr, wt))
        grids.append(label[: N_RINGS * N_THETA]
                     .reshape(N_RINGS, N_THETA).astype(np.float32))
        tg = testdata.truth_geometry(**p)
        ztops.append(np.float32(tg["z_top"]))
        ntrues.append(tg["n_true"].astype(np.float32))
        nss.append(np.float32(p["neck_shaft_deg"]))
        rads.append(np.float32(p["head_radius"]))
        flats.append(p.get("head_flattening", 0.0))
    return (specs, np.stack(grids), np.stack(ztops), np.stack(ntrues),
            np.stack(nss), np.stack(rads), np.asarray(flats))


def _iou(a, b):
    a, b = a > 0.5, b > 0.5
    inter = (a & b).sum(dim=(-2, -1))
    return inter / torch.clamp((a | b).sum(dim=(-2, -1)), min=1)


def _angle(a, b):
    c = torch.abs(torch.sum(a * b, dim=-1) / (
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1)))
    return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))


@torch.no_grad()
def eval_rows(bones, label_grids, z_tops, n_trues, truth_ns, truth_rad,
              cfg, rf, seg_model, hyp_idx=None):
    """The JAX tool's eval_one over a batch of bones (BoneTensors with a
    leading bone dim; the other arguments (B, ...) tensors on the bones'
    device): one row of COLS per bone, (B, 10) float32.  `hyp_idx`: the
    sphere segmenter's RANSAC quadruples, by default the pipeline's
    draw."""
    from shoulder_tpu_torch.models import segment
    from shoulder_tpu_torch.models import unet as unet_mod
    from shoulder_tpu_torch.ops import slicing
    from shoulder_tpu_torch.pipeline import landmarks as L
    from shoulder_tpu_torch.utils import geometry as geom

    n_bones, dev = bones.verts.shape[0], bones.verts.device
    verts_obb = geom.transform_pts(bones.verts, bones.obb_transform)
    sg = slicing.sorted_geom(verts_obb, bones.faces, bones.neighbors)

    def stack(zs, sset):
        return slicing.slice_stack(sg, zs, sset.interp_num, sset.band,
                                   COMPACT_K)

    full = stack(geom.linspace(cfg.z_inset * bones.z_max,
                               cfg.z_inset * bones.z_min,
                               cfg.full.zslice_num), cfg.full)
    neck_z, _, _, _ = L._surgical_neck(full, bones, False, cfg,
                                       cfg.max_chain, sg)
    prox = stack(geom.linspace(cfg.z_inset * bones.z_max, neck_z,
                               cfg.proximal.zslice_num), cfg.proximal)
    _, _, canal_axis, _, _ = L._canal(full, bones, False, cfg)
    bg_points, _, bg_theta, _, _ = L._groove(prox, bones, canal_axis, rf,
                                             cfg)
    image, pts = L._anp_image_points(prox, bg_theta, cfg)

    # the oracle mask: identity build frame -> (ring, theta) label cell
    # (the generator's ring grid spans [0, z_top], io/testdata.py)
    pts_ct = geom.transform_pts(pts.reshape(n_bones, -1, 3),
                                geom.inv_transform(bones.obb_transform))
    z_top = z_tops[:, None]
    z0 = torch.minimum(torch.clamp(pts_ct[..., 2], min=0.0), z_top)
    ring = torch.clamp(torch.round(z0 / z_top * (N_RINGS - 1))
                       .to(torch.int32), 0, N_RINGS - 1)
    th = torch.atan2(pts_ct[..., 1], pts_ct[..., 0])
    col = torch.round((th + math.pi) / (2 * math.pi) * N_THETA
                      ).to(torch.int32) % N_THETA
    oracle = label_grids.reshape(n_bones, -1).gather(
        1, (ring * N_THETA + col).long()).reshape(image.shape)

    # the three candidate masks
    unary = unet_mod.segment_image(seg_model, image)
    unary = segment._longest_cyclic_run_per_row(unary > 0.5).to(image.dtype)
    r, c = image.shape[-2:]
    if hyp_idx is None:
        hyp_idx = segment.ransac_indices(int(0.4 * r) * c, dev)
    sphere_args = (pts, hyp_idx, cfg.sphere_seg_iters, cfg.sphere_seg_tol_mm,
                   cfg.sphere_seg_init_top_rows)
    m_sphere, _, _, _ = segment.sphere_segment(*sphere_args)
    m_unet, _, _, _ = segment.sphere_segment(
        *sphere_args, init_mask=unary, support_mask=unary,
        support_tol_factor=cfg.sphere_seg_support_tol,
        support_min_disagree=cfg.sphere_seg_support_min_disagree,
        support_max_disagree=cfg.sphere_seg_support_max_disagree,
        support_min_recall=cfg.sphere_seg_support_min_recall,
        support_rescue_max_frac=cfg.sphere_seg_support_rescue_frac,
    )

    zero_te = torch.zeros((n_bones, 2, 3), device=dev)

    def plane_and_ns(mask):
        out = L._anp_from_mask(mask, pts, bones,
                               torch.zeros(n_bones, device=dev), 2048)
        _, _, ns = L._metrics(canal_axis, out[4], out[5], zero_te, bg_points,
                              True)
        return out[7], ns, out[8]

    # the parametric oracle: the generator's construction parameters
    n_o = torch.sum(bones.obb_transform[:, :3, :3] * n_trues[:, None, :],
                    dim=-1)
    n_s, ns_s, rad_s = plane_and_ns(m_sphere)
    n_u, ns_u, rad_u = plane_and_ns(m_unet)
    return torch.stack([
        _iou(unary, oracle), _iou(m_sphere, oracle), _iou(m_unet, oracle),
        _angle(n_s, n_o), _angle(n_u, n_o),
        torch.abs(ns_s - truth_ns), torch.abs(ns_u - truth_ns),
        torch.abs(rad_s - truth_rad), torch.abs(rad_u - truth_rad),
        truth_ns,
    ], dim=-1)


def run_cohorts(n_per_cohort=8, device="cuda", cfg=None, rf=None,
                seg_model=None):
    """{kind: {"rows": (n, 10), "flattening": (n,)}} of both cohorts on
    `device`, BATCH bones per eval batch (the JAX tool's run_cohorts).
    `cfg` defaults to DEFAULT_CONFIG; the forest and the UNet are loaded
    once when not given."""
    from shoulder_tpu_torch.bone import _device
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.models import forest, unet
    from shoulder_tpu_torch.pipeline import batch as B

    dev = _device(device)
    cfg = DEFAULT_CONFIG if cfg is None else cfg
    rf = forest.load_params(dev) if rf is None else rf
    seg_model = unet.load_model(dev) if seg_model is None else seg_model
    results = {}
    for kind, seed in SEEDS:
        params_list = _cohort_params(kind, n_per_cohort, seed)
        rows, flats = [], []
        for start in range(0, len(params_list), BATCH):
            chunk_p = params_list[start:start + BATCH]
            specs, *arrays, flat = cohort_inputs(chunk_p, kind, start)
            tensors = [torch.as_tensor(a, device=dev) for a in arrays]
            out = eval_rows(B.stack_bones(specs, dev), *tensors, cfg, rf,
                            seg_model)
            rows.append(out.cpu().numpy())
            flats.append(flat)
            print(f"[eval] {kind} {start + len(chunk_p)}/{len(params_list)}",
                  flush=True)
        results[kind] = {"rows": np.concatenate(rows, axis=0),
                         "flattening": np.concatenate(flats)}
    return results


def main(argv=None):
    from shoulder_tpu_torch.bone import _device
    from shoulder_tpu_torch.utils import bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = bench.card() if dev.type == "cuda" else "cpu (no card)"
    print(f"[eval] card: {card}", flush=True)
    results = run_cohorts(args.n, dev)
    summary = summarize(results)
    for name, s in summary.items():
        print(f"\n== {name} (n={s['n']}) ==")
        for c in COLS:
            print(f"  {c:24s} {s[c]:8.3f}")
    rows = {kind: {"rows": d["rows"].tolist(),
                   "flattening": d["flattening"].tolist()}
            for kind, d in results.items()}
    OUT.write_text(json.dumps({**summary, "rows": rows, "card": card},
                              indent=2))
    print(f"\nwrote {OUT} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
