"""Regenerate the PyTorch port's accuracy evidence in one command.  The
twin of tools/refresh_evidence.py.

Runs the port's evaluators, each in its own subprocess on the device,
and rewrites the accuracy table between this tool's markers inside
README.md's "PyTorch / H100 port" section from their outputs (PARITY.md
holds the JAX package's table and is not touched):

  * tools/eval_accuracy_torch_results.json  (DEFAULT pipeline vs truth)
  * tools/eval_accuracy_torch_sphere.json   (segmenter="sphere" A/B arm)
  * tools/eval_articular_torch_results.json (mask IoU + plane / NS /
                                             radius vs the parametric
                                             oracle, both segmenters)
  * tools/eval_arthritic_ab_torch_results.json (the arthritic A/B)

The table carries the card's name and power limit.  There is no CPU
fallback: without a CUDA device it raises unless `--device cpu` is given.

    python3 tools/refresh_evidence_torch.py [n_per_cohort] [--device cpu]
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
TOOLS = ROOT / "tools"
README = ROOT / "README.md"

BEGIN = ("<!-- TORCH-ACCURACY-TABLE:BEGIN (generated by "
         "tools/refresh_evidence_torch.py) -->")
END = "<!-- TORCH-ACCURACY-TABLE:END -->"
SECTION = "## PyTorch / H100 port"


def run(cmd):
    print(f"[refresh] $ {' '.join(cmd)}", flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT)


def accuracy_table_md(n: int) -> str:
    acc = json.loads((TOOLS / "eval_accuracy_torch_results.json").read_text())
    sph = json.loads((TOOLS / "eval_accuracy_torch_sphere.json").read_text())
    art = json.loads(
        (TOOLS / "eval_articular_torch_results.json").read_text())
    ab = json.loads(
        (TOOLS / "eval_arthritic_ab_torch_results.json").read_text())

    lines = [
        BEGIN,
        "",
        f"The port's accuracy on the exact-truth synthetic cohorts, on "
        f"{acc['card']}",
        f"(n={n}/cohort, `tools/eval_accuracy_torch.py`; DEFAULT config vs "
        "the `segmenter=\"sphere\"` A/B arm).",
        "Errors are (recovered − constructed truth).",
        "",
        "| cohort | segmenter | side acc | NS err mean / \\|max\\| (deg) | "
        "RV err mean / \\|max\\| (deg) | radius err mean / \\|max\\| (mm) |",
        "|---|---|---|---|---|---|",
    ]
    for cohort in ("healthy", "arthritic"):
        for label, data in (("default (unet)", acc), ("sphere", sph)):
            s = data[cohort]["summary"]
            lines.append(
                f"| {cohort} | {label} | {s['side_acc'] * 100:.0f}% "
                f"| {s['ns_err']['mean']:+.2f} / {s['ns_err']['abs_max']:.2f} "
                f"| {s['rv_err']['mean']:+.2f} / {s['rv_err']['abs_max']:.2f} "
                f"| {s['r_err']['mean']:+.2f} / {s['r_err']['abs_max']:.2f} |"
            )
    lines += [
        "",
        "Articular-mask quality vs the parametric oracle "
        f"(`tools/eval_articular_torch.py`, means; {art['card']}):",
        "",
        "| cohort | n | unary IoU | sphere IoU | unet IoU | "
        "plane err sphere/unet (deg) | NS err sphere/unet (deg) |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, s in art.items():
        if name in ("rows", "card"):
            continue
        lines.append(
            f"| {name} | {s['n']} | {s['iou_unary']:.3f} "
            f"| {s['iou_sphere']:.3f} | {s['iou_unet']:.3f} "
            f"| {s['plane_err_sphere_deg']:.2f} / {s['plane_err_unet_deg']:.2f} "
            f"| {s['ns_err_sphere_deg']:.2f} / {s['ns_err_unet_deg']:.2f} |"
        )
    errs = {seg: [abs(r[f"{seg}_ns"] - r["truth_ns"]) for r in ab["rows"]]
            for seg in ("sphere", "unet")}
    lines += [
        "",
        f"Arthritic A/B (`tools/eval_arthritic_ab_torch.py`, "
        f"{len(ab['rows'])} bones; {ab['card']}): neck-shaft |err| mean / "
        "max "
        + ", ".join(f"{seg} {sum(e) / len(e):.2f} / {max(e):.2f} deg"
                    for seg, e in errs.items())
        + ".",
        "",
        END,
    ]
    return "\n".join(lines)


def rewrite_readme(table: str) -> None:
    """Put `table` between the markers, or at the end of the port's
    section when they are not there yet."""
    text = README.read_text()
    block = re.compile(re.escape(BEGIN) + ".*?" + re.escape(END), re.S)
    if block.search(text):
        text = block.sub(lambda _: table, text)
    else:
        start = text.index(SECTION)
        nxt = text.find("\n## ", start + len(SECTION))
        end = len(text) if nxt < 0 else nxt
        text = (text[:end].rstrip() + "\n\n" + table + "\n"
                + text[end:])
    README.write_text(text)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from shoulder_tpu_torch.bone import _device

    _device(args.device)
    dev = ["--device", args.device]
    py = sys.executable
    run([py, "tools/eval_accuracy_torch.py", str(args.n), *dev])
    run([py, "tools/eval_accuracy_torch.py", str(args.n), "sphere", *dev])
    run([py, "tools/eval_articular_torch.py", str(args.n), *dev])
    run([py, "tools/eval_arthritic_ab_torch.py", str(args.n), *dev])
    rewrite_readme(accuracy_table_md(args.n))
    print("[refresh] README.md's port accuracy table rewritten")
    return 0


if __name__ == "__main__":
    sys.exit(main())
