"""The comparison that decides `correct`.

An answer is a dict of named arrays by kind: `mm` (points, axes, loops,
the head radius, residuals, and for CT the welded mesh's vertices),
`deg` (angles), `unit` (directions, compared by the angle between them,
deg), `frac` (shares) and `exact` (the side, the QC flags, for CT the
mesh's sizes).  Each non-exact entry belongs, by its name, to one of the
numbers compared, each against the configuration's `limits`:

- `widest_mm`, `widest_deg`, `widest_frac`: the widest gap, over every
  answer of the window, of the entries that the card's kernels and their
  plain versions leave within rounding on every bone (the head radius,
  the canal, the anatomic-neck plane and axes that the UNet's mask sets,
  neck-shaft, the QC measures, the CT mesh);
- `te_deg`: the widest gap of the directions the transepicondylar axis
  sets, the retroversion and the coordinate system's axes, which the
  epicondyles' coarse angle search may move by one step (0.2277 deg);
- `groove_share`, `te_share`, `rim_share`, `neck_share`: for the
  entries of the pipeline's discrete choices (the groove's peaks; the
  epicondyles' points and the coordinate system's origin; the RANSAC
  rim; the surgical neck's slice), the share of answers whose gap passes
  JUMP, the largest over the group's entries.  The ~1e-5 mm by which the kernels and their plain versions
  differ turn these into jumps of 0.2-33 mm on some of the bones
  (PERF.md), so their widest gap reads the same for sound and broken
  runs, and how many bones jump does not;
- `flags`: the answers whose exact entries differ.

Point sets of different lengths (a loop or a mask that took another
size) are compared by their Hausdorff distance; any other array whose
shape differs counts as an infinite gap for that answer.
"""

from __future__ import annotations

import math

import numpy as np

KINDS = ("mm", "deg", "unit", "frac", "exact")
# an entry of a discrete choice has jumped where its gap passes this (mm
# or deg): above the widest gap of every steady entry on sound runs, below
# the smallest jump (PERF.md)
JUMP = 0.05
GROUPS = {
    "widest_mm": ("radius_curvature", "mesh_vertices", "canal_axis",
                  "canal_points", "anp_plane_point", "anp_axis_central",
                  "anp_axis_normal", "qc_sphere_resid", "qc_canal_fit_rms"),
    "widest_deg": ("neckshaft", "anp_plane_normal"),
    "widest_frac": ("qc_rf_pos_frac", "qc_mask_area_frac"),
    "te_deg": ("retroversion", "csys_axes"),
    "groove_share": ("bg_axis", "bg_points", "bg_theta"),
    "te_share": ("te_axis", "csys_translation"),
    "rim_share": ("anp_points",),
    "neck_share": ("neck_z", "sn_points"),
}
NUMBERS = tuple(GROUPS) + ("flags",)
NUMBER_OF = {entry: number for number, entries in GROUPS.items()
             for entry in entries}
SHARES = tuple(n for n in GROUPS if n.endswith("_share"))


def _gap(a, b) -> float:
    """Largest |a - b| over finite pairs; inf where one side is NaN or
    infinite and the other is not."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb) or not np.array_equal(a[~fa], b[~fb],
                                                        equal_nan=True):
        return math.inf
    if not fa.any():
        return 0.0
    return float(np.abs(a[fa] - b[fa]).max())


def _hausdorff(a, b) -> float:
    """Symmetric Hausdorff distance between point sets (n, 3), (m, 3)."""
    from scipy.spatial import cKDTree

    if not len(a) or not len(b):
        return 0.0 if len(a) == len(b) else math.inf
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return math.inf
    return float(max(cKDTree(b).query(a)[0].max(),
                     cKDTree(a).query(b)[0].max()))


def _angle_deg(u, v) -> float:
    """Largest angle between paired vectors (last axis), degrees."""
    u = np.asarray(u, np.float64).reshape(-1, 3)
    v = np.asarray(v, np.float64).reshape(-1, 3)
    if not len(u):
        return 0.0
    if not (np.isfinite(u).all() and np.isfinite(v).all()):
        return 0.0 if np.array_equal(u, v, equal_nan=True) else math.inf
    cross = np.linalg.norm(np.cross(u, v), axis=1)
    dot = np.einsum("ij,ij->i", u, v)
    return float(np.degrees(np.arctan2(cross, dot)).max())


def field_gaps(got: dict, want: dict) -> tuple[dict, list]:
    """({name: gap} over every non-exact entry, [exact entries that
    differ]) of one answer against the reference's."""
    gaps, wrong = {}, []
    for kind in KINDS:
        g, w = got.get(kind, {}), want.get(kind, {})
        for name in set(g) | set(w):
            if name not in g or name not in w:
                wrong.append(f"{kind}.{name} missing")
                continue
            a, b = np.asarray(g[name]), np.asarray(w[name])
            if kind == "exact":
                if a.shape != b.shape or not np.array_equal(a, b):
                    wrong.append(f"{name} {a.tolist()} != {b.tolist()}")
            elif a.shape != b.shape:
                points = (a.ndim == b.ndim == 2 and a.shape[1:] == (3,)
                          and b.shape[1:] == (3,))
                gaps[name] = _hausdorff(a, b) if points else math.inf
            elif kind == "unit":
                gaps[name] = _angle_deg(a, b)
            else:
                gaps[name] = _gap(a, b)
    return gaps, wrong


def judge(pairs, limits: dict) -> dict:
    """pairs: (key, got, want) for every answer of the window.  Returns
    {"numbers": {name: {"value", "limit"}}, "correct", "failed" (answers
    with a widest-gap entry beyond its limit or an exact entry that
    differs), "worst": where each widest number was set, "widest":
    {entry: its widest gap}, "share": {entry: the share of answers whose
    gap passes JUMP}; the last two printed for every entry}."""
    values = {n: 0.0 for n in NUMBERS}
    wide: dict = {}
    jumped: dict = {}
    counted: dict = {}
    worst: dict = {}
    flags = failed = 0
    for key, got, want in pairs:
        gaps, wrong = field_gaps(got, want)
        bad = bool(wrong)
        if wrong:
            flags += 1
            worst.setdefault("flags", (key, wrong[:4]))
        for name, gap in gaps.items():
            number = NUMBER_OF[name]
            wide[name] = max(wide.get(name, 0.0), gap)
            counted[name] = counted.get(name, 0) + 1
            jumped[name] = jumped.get(name, 0) + (gap > JUMP)
            if number in SHARES:
                continue
            if gap > values[number]:
                values[number] = gap
                worst[number] = (key, name)
            bad |= gap > limits[number]
        failed += bad
    share = {name: jumped[name] / counted[name] for name in counted}
    for name, s in share.items():
        number = NUMBER_OF[name]
        if number in SHARES and s > values[number]:
            values[number] = s
            worst[number] = ("share of answers", name)
    values["flags"] = flags
    out = {n: {"value": values[n], "limit": limits[n]} for n in NUMBERS}
    correct = all(values[n] <= limits[n] for n in NUMBERS)
    return {"numbers": out, "correct": correct, "failed": failed,
            "worst": worst, "widest": wide, "share": share}
