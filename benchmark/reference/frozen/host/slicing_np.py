"""Exact host-side (numpy) cross-section extraction.

This is the reference-equivalent slicer: it produces ordered, CCW-oriented
closed contour loops of a watertight mesh cut by z-planes, matching what the
reference obtains from trimesh.section/section_multiplane (reference
slice.py:26, mesh.py:95,159, surgical_neck.py:37).

It has two jobs:
  1. ingest-time orientation decisions with data-dependent shapes
     (head-end detection mesh.py:89-117, ProxObb area scan mesh.py:150-190),
  2. the oracle that the batched device slice kernel is tested against.

The device kernel (ops/slicing.py) implements the same geometry as
dense fixed-shape ops.
"""

from __future__ import annotations

import numpy as np


def _face_crossings(vertices, faces, z, eps_scale=1e-12):
    """Per-face plane crossing data at plane z.

    Returns (crossed_mask (F,), pts (F,2,2), exit_slot (F,), entry_slot (F,)).
    pts[f,0] is the oriented segment start, pts[f,1] the end, in xy.
    Orientation is z_hat x face_normal, i.e. interior-on-the-left (CCW
    exterior loops, CW holes) for outward-wound faces.
    """
    d = vertices[:, 2] - z
    # symbolic perturbation: vertices exactly on the plane count as above
    d = np.where(d == 0.0, eps_scale, d)
    fd = d[faces]  # (F, 3)
    pos = fd > 0
    # edge slots: 0:(v0,v1) 1:(v1,v2) 2:(v2,v0)
    cross_edge = pos != np.roll(pos, -1, axis=1)  # (F,3)
    crossed = cross_edge.sum(axis=1) == 2

    # the geometric work below runs on the crossed subset only (a few
    # hundred faces of tens of thousands) — this host slicer is on the
    # per-bone ingest path (head-end detection, ProxObb area scan), where
    # the full-face-set temporaries were ~half the ingest cost.  Results
    # scatter back into full-size arrays; arithmetic on crossed faces is
    # unchanged, so outputs are bit-identical for every face callers read.
    idx = np.flatnonzero(crossed)
    F = len(faces)
    pts = np.zeros((F, 2, 2), vertices.dtype)
    exit_slot = np.zeros(F, np.int64)
    entry_slot = np.zeros(F, np.int64)
    if idx.size:
        fv = vertices[faces[idx]]  # (C,3,3)
        fi = fv
        fj = np.roll(fv, -1, axis=1)
        di = fd[idx]
        dj = np.roll(di, -1, axis=1)
        # uncrossed slots have di == dj in sign (and possibly value): guard
        # the denominator so they never raise divide-by-zero / inf*0
        # warnings — their t is garbage but those slots are masked out below
        denom = di - dj
        denom = np.where(denom == 0.0, 1.0, denom)
        t = di / denom
        pts_all = fi + t[..., None] * (fj - fi)  # (C,3,3) per-slot points

        # for each crossed face pick its two crossing slots
        slot_idx = np.argsort(
            ~cross_edge[idx], axis=1, kind="stable"
        )[:, :2]  # (C,2)
        p = np.take_along_axis(pts_all, slot_idx[..., None], axis=1)[..., :2]

        # face normal (outward by STL winding)
        n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        dir2d = np.stack([-n[:, 1], n[:, 0]], axis=1)  # (z_hat x n).xy
        seg = p[:, 1] - p[:, 0]
        forward = np.einsum("fi,fi->f", seg, dir2d) >= 0
        start = np.where(forward[:, None], p[:, 0], p[:, 1])
        end = np.where(forward[:, None], p[:, 1], p[:, 0])
        pts[idx] = np.stack([start, end], axis=1)
        exit_slot[idx] = np.where(forward, slot_idx[:, 1], slot_idx[:, 0])
        entry_slot[idx] = np.where(forward, slot_idx[:, 0], slot_idx[:, 1])
    return crossed, pts, exit_slot, entry_slot


def cross_section(vertices, faces, neighbors, z):
    """Cut the mesh at plane z (normal +z).

    Returns a list of loops; each loop is a dict with:
      points  (N,2) ordered CCW (exterior) / CW (hole), no repeated endpoint
      area    signed shoelace area (positive = exterior)
      centroid(2,) area centroid
    """
    crossed, pts, exit_slot, _ = _face_crossings(vertices, faces, z)
    loops = []
    visited = np.zeros(len(faces), dtype=bool)
    for f0 in np.flatnonzero(crossed):
        if visited[f0]:
            continue
        loop_faces = []
        f = f0
        while True:
            visited[f] = True
            loop_faces.append(f)
            nxt = neighbors[f, exit_slot[f]]
            if nxt < 0 or not crossed[nxt]:
                break  # open curve (non-watertight); keep what we have
            if nxt == f0:
                break
            if visited[nxt]:
                break
            f = nxt
        points = pts[loop_faces, 0]  # start point of each oriented segment
        if len(points) < 3:
            continue
        x, y = points[:, 0], points[:, 1]
        xn, yn = np.roll(x, -1), np.roll(y, -1)
        cross = x * yn - xn * y
        area = 0.5 * np.sum(cross)
        if abs(area) < 1e-12:
            continue
        cx = np.sum((x + xn) * cross) / (6.0 * area)
        cy = np.sum((y + yn) * cross) / (6.0 * area)
        loops.append(
            {"points": points, "area": area, "centroid": np.array([cx, cy])}
        )
    return loops


def section_area(vertices, faces, neighbors, z):
    """Total enclosed area at plane z (exteriors minus holes)."""
    return sum(l["area"] for l in cross_section(vertices, faces, neighbors, z))


def largest_loop(loops):
    """The loop with the largest signed area (reference slice.py:52-60)."""
    return max(loops, key=lambda l: l["area"])


def resample_polygon(xy: np.ndarray, interp_num: int) -> np.ndarray:
    """Arc-length resample of an ordered point sequence.

    Exact semantics of reference Slices._resample_polygon (slice.py:166-189):
    cumulative euclidean distance, linspace sampling, linear interp.  The
    input should be a closed loop with the first point repeated at the end
    (trimesh's `discrete` convention).
    """
    d = np.cumsum(
        np.r_[0, np.sqrt((np.diff(xy, axis=0) ** 2).sum(axis=1))]
    )
    d_sampled = np.linspace(0, d.max(), interp_num)
    return np.c_[
        np.interp(d_sampled, d, xy[:, 0]), np.interp(d_sampled, d, xy[:, 1])
    ]


def close_loop(points: np.ndarray) -> np.ndarray:
    """Append the first point, producing trimesh-style closed discrete path."""
    return np.vstack([points, points[:1]])
