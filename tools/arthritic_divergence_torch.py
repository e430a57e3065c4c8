"""Where the port's arthritic accuracy cohort departs between the card and
the CPU, stage by stage, and which swap brings the card back.

The cohort is `chip_smoke.accuracy_cohort`'s arthritic one (the healthy
cohort drawn first from `default_rng(2026)`, as tests/test_accuracy_gate.py
draws it).  It runs as one `compute_landmarks_batch` at DEFAULT_CONFIG on
the card and on the CPU in this process, and for each bone prints the
first stage whose values depart, in the pipeline's order:

  1. the polar image handed to `models.unet.segment_image` (max |diff|);
  2. the UNet's logits (max |diff|) and mask (pixels that differ);
  3. the support gate: its strict sphere mask, disagreement, recall and
     strict fraction, and its engage and rescue decisions;
  4. the sphere consensus (radius, centre);
  5. the anatomic-neck plane normal (angle);
  6. the neck-shaft angle, retroversion and head radius, also against the
     JAX package's rows in tools/eval_accuracy_results.json.

Then the swaps that separate the causes:

  a. the card's batch with the CPU's UNet masks in place of its own;
  b. the CPU's batch with the card's masks;
  c. the card's sphere consensus on the CPU's inputs (points and mask);
  d. both sides with `UNet(compute_dtype=torch.float32)`;
  e. the card's bf16 UNet on the CPU's polar images, against the CPU's
     (the same images: only the convolutions' arithmetic differs).

Run:  python tools/arthritic_divergence_torch.py [--bones 0,5] [--card cuda:0]
(`--card cpu` rehearses the tool with the CPU on both sides.)  With
`--out PATH` a JSON summary of every number goes to PATH.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

import chip_smoke
from shoulder_tpu_torch.config import DEFAULT_CONFIG as CFG
from shoulder_tpu_torch.models import forest, segment, unet
from shoulder_tpu_torch.pipeline import batch as B
from shoulder_tpu_torch.pipeline import landmarks as L

# a stage "departs" when its card-vs-CPU difference passes these
DEPART = dict(image=1e-4, logit_pixels=0, radius_mm=1e-3,
              normal_deg=1e-3, metric_deg=0.01)
# the functions the swaps below wrap
SEGMENT_IMAGE = unet.segment_image
SPHERE_SEGMENT = segment.sphere_segment


def cohort(bones):
    rng = np.random.default_rng(2026)
    chip_smoke.accuracy_cohort(rng, False)
    specs, truth = chip_smoke.accuracy_cohort(rng, True)
    with open(ROOT / "tools" / "eval_accuracy_results.json") as fh:
        rows = json.load(fh)["arthritic"]["rows"]
    return ([specs[i] for i in bones], [truth[i] for i in bones],
            np.array([[rows[i]["ns"], rows[i]["rv"], rows[i]["r"]]
                      for i in bones]))


def logits_of(model, image):
    """segment_image's logits (B, H, W) of polar images (B, H, W)."""
    h, w = image.shape[-2:]
    m = 1 << len(model.down)
    x = torch.nn.functional.pad(image[:, None], (0, (-w) % m, 0, (-h) % m))
    with torch.no_grad():
        return model(x)[:, 0, :h, :w].float()


def gate(args, kwargs, unary):
    """The support gate's inputs and decisions per bone, from one
    sphere_segment call: its strict mask is the mask of the same call
    without a support mask."""
    kw = dict(kwargs, init_mask=kwargs["init_mask"], support_mask=None)
    strict = SPHERE_SEGMENT(*args, **kw)[0].flatten(1) > 0.5
    sup = unary.flatten(1) > 0.5
    disagree = (sup & ~strict).sum(1) / torch.clamp(sup.sum(1), min=1)
    recall = (sup & strict).sum(1) / torch.clamp(strict.sum(1), min=1)
    frac = strict.sum(1) / strict.shape[1]
    plausible = ((disagree < CFG.sphere_seg_support_max_disagree)
                 & (recall > CFG.sphere_seg_support_min_recall))
    rescue = frac < CFG.sphere_seg_support_rescue_frac
    engage = (disagree > CFG.sphere_seg_support_min_disagree) & (
        plausible | rescue)
    return dict(strict=strict.cpu(), disagree=disagree.cpu(),
                recall=recall.cpu(), strict_frac=frac.cpu(),
                rescue=rescue.cpu(), engage=engage.cpu())


def run(specs, dev, rf, seg, masks=None):
    """One batch on `dev`; what each stage saw and gave.  `masks`: UNet
    masks to use in place of the model's own."""
    images, spheres = [], []

    def seg_fn(model, image):
        images.append(image)
        return (masks.to(image.device) if masks is not None
                else SEGMENT_IMAGE(model, image))

    def sph_fn(*args, **kwargs):
        out = SPHERE_SEGMENT(*args, **kwargs)
        spheres.append((args, kwargs, out))
        return out

    with chip_smoke.swapped(L.unet_mod, "segment_image", seg_fn), \
            chip_smoke.swapped(L.segment, "sphere_segment", sph_fn):
        lm = B.compute_landmarks_batch(B.stack_bones(specs, dev), rf,
                                       cfg=CFG, seg_model=seg)
    image = images[0]
    args, kwargs, (mask, radius, center, _resid) = spheres[0]
    unary = kwargs["support_mask"]
    return dict(
        image=image.cpu(), logits=logits_of(seg, image).cpu(),
        unary=unary.cpu(), args=args, kwargs=kwargs,
        gate=gate(args, kwargs, unary), mask=mask.cpu(), radius=radius.cpu(),
        center=center.cpu(), normal=lm.anp_plane_normal.cpu().double(),
        metrics=np.stack([lm.neckshaft.cpu().numpy(),
                          lm.retroversion.cpu().numpy(),
                          lm.radius_curvature.cpu().numpy()], 1)
        .astype(np.float64))


def angle_deg(a, b):
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))


def compare(card, cpu, bones):
    """Per bone: each stage's difference and the first that departs."""
    out = []
    for j, bone in enumerate(bones):
        gc, gp = card["gate"], cpu["gate"]
        d = {
            "bone": bone,
            "image": float((card["image"][j] - cpu["image"][j]).abs().max()),
            "logit": float((card["logits"][j] - cpu["logits"][j]).abs().max()),
            "logit_pixels": int(((card["logits"][j] > 0)
                                 != (cpu["logits"][j] > 0)).sum()),
            "unary_pixels": int((card["unary"][j] != cpu["unary"][j]).sum()),
            "strict_pixels": int((gc["strict"][j] != gp["strict"][j]).sum()),
            "gate": {k: [float(gc[k][j]), float(gp[k][j])] for k in
                     ("disagree", "recall", "strict_frac", "rescue",
                      "engage")},
            "radius_mm": float((card["radius"][j] - cpu["radius"][j]).abs()),
            "center_mm": float((card["center"][j] - cpu["center"][j]).norm()),
            "mask_pixels": int((card["mask"][j] != cpu["mask"][j]).sum()),
            "normal_deg": float(angle_deg(card["normal"][j],
                                          cpu["normal"][j])),
            "metrics": (card["metrics"][j] - cpu["metrics"][j]).tolist(),
        }
        gate_differs = any(bool(gc[k][j]) != bool(gp[k][j])
                           for k in ("rescue", "engage"))
        tests = (("polar image", d["image"] > DEPART["image"]),
                 ("UNet logits and mask",
                  d["logit_pixels"] > DEPART["logit_pixels"]),
                 ("support gate", gate_differs or d["strict_pixels"] > 0),
                 ("sphere consensus", d["radius_mm"] > DEPART["radius_mm"]),
                 ("anatomic-neck normal",
                  d["normal_deg"] > DEPART["normal_deg"]),
                 ("neck-shaft angle",
                  abs(d["metrics"][0]) > DEPART["metric_deg"]))
        d["first_departs"] = next((name for name, hit in tests if hit), None)
        out.append(d)
    return out


def vs_rows(name, metrics, rows, bones):
    diff = metrics - rows
    for j, bone in enumerate(bones):
        print(f"{name} bone {bone}: ns / rv / radius {np.round(metrics[j], 3)}"
              f", - JAX row {np.round(diff[j], 4)}", flush=True)
    print(f"{name}: max |- JAX row| {np.round(np.abs(diff).max(0), 4)}",
          flush=True)
    return diff.tolist()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bones", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--card", default="cuda:0")
    ap.add_argument("--out", help="write a JSON summary here")
    args = ap.parse_args()
    bones = [int(b) for b in args.bones.split(",")]
    card = torch.device(args.card)
    if card.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("arthritic_divergence_torch: no CUDA device")
        smi = chip_smoke.card()
    else:
        smi = "rehearsal on the CPU"
    b = torch.backends
    print(f"{smi}; torch {torch.__version__}; matmul TF32 "
          f"{b.cuda.matmul.allow_tf32}, cuDNN TF32 {b.cudnn.allow_tf32}, "
          f"bf16 reduced-precision reduction "
          f"{b.cuda.matmul.allow_bf16_reduced_precision_reduction}, CPU "
          f"threads {torch.get_num_threads()}", flush=True)

    specs, truth, rows = cohort(bones)
    cpu = torch.device("cpu")
    rf = {d: forest.load_params(d) for d in (card, cpu)}
    seg = {d: unet.load_model(d) for d in (card, cpu)}
    flat = unet.load_flat(unet.DEFAULT_NPZ)
    seg32 = {d: unet.model_from_flat(flat, torch.float32).to(d)
             for d in (card, cpu)}
    report = {"card": smi, "bones": bones}

    res = {d: run(specs, d, rf[d], seg[d]) for d in (card, cpu)}
    stages = compare(res[card], res[cpu], bones)
    for d in stages:
        print(f"bone {d['bone']}: first departs at {d['first_departs']}; "
              f"{json.dumps({k: v for k, v in d.items() if k != 'bone'})}",
              flush=True)
    report["stages"] = stages
    report["card_vs_rows"] = vs_rows("card bf16 UNet",
                                     res[card]["metrics"], rows, bones)
    report["cpu_vs_rows"] = vs_rows("cpu bf16 UNet", res[cpu]["metrics"],
                                    rows, bones)

    # (a), (b): each side with the other's UNet masks
    swap_a = run(specs, card, rf[card], seg[card], masks=res[cpu]["unary"])
    report["a_card_with_cpu_masks"] = vs_rows(
        "(a) card with the CPU's masks", swap_a["metrics"], rows, bones)
    swap_b = run(specs, cpu, rf[cpu], seg[cpu], masks=res[card]["unary"])
    report["b_cpu_with_card_masks"] = vs_rows(
        "(b) cpu with the card's masks", swap_b["metrics"], rows, bones)

    # (c): the card's sphere consensus on the CPU's inputs
    c_args = tuple(x.to(card) if torch.is_tensor(x) else x
                   for x in res[cpu]["args"])
    c_kwargs = {k: v.to(card) if torch.is_tensor(v) else v
                for k, v in res[cpu]["kwargs"].items()}
    mask_c, rad_c, cen_c, _ = segment.sphere_segment(*c_args, **c_kwargs)
    report["c_sphere_on_cpu_inputs"] = []
    for j, bone in enumerate(bones):
        row = {"bone": bone,
               "mask_pixels": int((mask_c[j].cpu() != res[cpu]["mask"][j])
                                  .sum()),
               "radius_mm": float((rad_c[j].cpu() - res[cpu]["radius"][j])
                                  .abs()),
               "center_mm": float((cen_c[j].cpu() - res[cpu]["center"][j])
                                  .norm())}
        print(f"(c) card sphere consensus on the CPU's inputs: {row}",
              flush=True)
        report["c_sphere_on_cpu_inputs"].append(row)

    # (d): float32 UNet on both sides
    res32 = {d: run(specs, d, rf[d], seg32[d]) for d in (card, cpu)}
    stages32 = compare(res32[card], res32[cpu], bones)
    for d in stages32:
        print(f"(d) float32 UNet, bone {d['bone']}: first departs at "
              f"{d['first_departs']}; logit pixels {d['logit_pixels']}, "
              f"metrics card - cpu {np.round(d['metrics'], 4)}", flush=True)
    report["d_stages_f32"] = stages32
    report["d_card_f32_vs_rows"] = vs_rows("(d) card float32 UNet",
                                           res32[card]["metrics"], rows, bones)
    report["d_cpu_f32_vs_rows"] = vs_rows("(d) cpu float32 UNet",
                                          res32[cpu]["metrics"], rows, bones)
    # (e): the card's bf16 UNet on the CPU's images
    image = res[cpu]["image"]
    logits_e = logits_of(seg[card], image.to(card)).cpu()
    report["e_card_unet_on_cpu_images"] = []
    for j, bone in enumerate(bones):
        row = {"bone": bone,
               "image_pixels_1e-4": int(((res[card]["image"][j] - image[j])
                                         .abs() > 1e-4).sum()),
               "logit": float((logits_e[j] - res[cpu]["logits"][j]).abs()
                              .max()),
               "mask_pixels": int(((logits_e[j] > 0)
                                   != (res[cpu]["logits"][j] > 0)).sum())}
        print(f"(e) card bf16 UNet on the CPU's image: {row}", flush=True)
        report["e_card_unet_on_cpu_images"].append(row)
    report["truth"] = truth
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {args.out} ({smi})", flush=True)


if __name__ == "__main__":
    main()
