"""Miscellaneous helpers (numpy), a copy of shoulder_tpu/utils/extras.py:
IGES line export, z-score outlier filter, closest point,
rotation-alignment matrix, angle between vectors.
"""

from __future__ import annotations

import numpy as np

_IGES_HEADER = (
    "{:72s}S0000001\n".format("shoulder_tpu IGES line export")
    + "{:72s}G0000001\n".format(
        "1H,,1H;,4Hline,4Hline,12Hshoulder_tpu,12Hshoulder_tpu,32,38,6,308,"
    )
    + "{:72s}G0000002\n".format("15,4Hline,1.,2,2HMM,50,0.125,13H870508.123456,")
    + "{:72s}G0000003\n".format("1.E-08,500.,,,11,0,13H870508.123456;")
    + "     110       1       0       1       0       0       0       000000000D0000001\n"
    + "     110       0       0       1       0                    LINE       0D0000002\n"
)


def write_iges_line(line, filepath) -> None:
    """Export a 2x3 line segment as a minimal IGES file
    (reference utils.py:7-24 capability)."""
    (x, y, z), (x1, y1, z1) = np.asarray(line)
    param = f"110,{x},{y},{z},{x1},{y1},{z1};"
    body = param.ljust(71) + "1P0000001\n"
    term = (
        "S      1G      3D      2P      1"
        + " " * 40
        + "T0000001"
    )
    with open(filepath, "w") as fh:
        fh.write(_IGES_HEADER + body + term)


def z_score_filter(arr, idx, threshold):
    """Drop rows whose median-centered z-score at column idx exceeds the
    threshold (reference utils.py:27-31 semantics)."""
    arr = np.asarray(arr)
    centered = arr - np.median(arr, axis=0)
    std = centered.std(axis=0, ddof=0)
    std = np.where(std == 0, 1.0, std)
    z = np.abs((centered - centered.mean(axis=0)) / std)[:, idx]
    return arr[z < threshold]


def closest_pt(pt, pts, return_other_pts: bool = False):
    """Closest point in `pts` to `pt` (reference utils.py:136-146); brute
    force — no kd-tree dependency needed at these sizes."""
    pts = np.asarray(pts)
    d = np.linalg.norm(pts - np.asarray(pt), axis=1)
    i = int(np.argmin(d))
    if return_other_pts:
        return [pts[i], np.delete(pts, i, axis=0)]
    return pts[i]


def rot_matrix_3d(vec1, vec2) -> np.ndarray:
    """Rotation aligning vec1 to vec2 (Rodrigues; reference utils.py:151-165)."""
    a = np.asarray(vec1, dtype=float)
    b = np.asarray(vec2, dtype=float)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = np.linalg.norm(v)
    if s < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k * ((1 - c) / s**2)


def angle_between(v1, v2) -> float:
    """Angle between two 3D vectors in degrees (reference utils.py:274-286)."""
    v1 = np.asarray(v1, dtype=float)
    v2 = np.asarray(v2, dtype=float)
    cosang = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return float(np.rad2deg(np.arccos(np.clip(cosang, -1.0, 1.0))))
