"""Host-side minimum-volume oriented bounding box.

Replaces trimesh's `apply_obb` (reference mesh.py:82,144).  Algorithm: convex
hull (qhull), then for every hull-face normal the exact 2D minimum-area
rectangle of the projected hull (rotating over hull-edge directions), keeping
the minimum-volume box.  This matches trimesh.bounds.oriented_bounds'
strategy, including the convention that the returned transform carries the
mesh to a frame whose AABB is centered at the origin with extents sorted
ascending (x smallest, z largest) — the reference's downstream code depends
on z being the long axis of the humerus (mesh.py:85-117).

OBB runs once per bone at ingest on the host; it is not on the device hot
path.  `oriented_bounds` searches the candidates in the port's native
library (io/native.py, csrc/obb.cpp), as shoulder_tpu/host/obb.py does with
its own: the same box, bit for bit, on the same hull.  The numpy loop
(`search_numpy`, `oriented_bounds_numpy`) is the oracle the tests hold it
against.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull

from shoulder_tpu_torch.io import native
from shoulder_tpu_torch.utils import trace


def _min_area_rect_2d(pts2d: np.ndarray):
    """Exact minimum-area rectangle of a 2D point set.

    Returns (area, u, v, (umin, umax, vmin, vmax)) where u/v are the unit
    rectangle axes in the input frame.
    """
    hull = ConvexHull(pts2d)
    hp = pts2d[hull.vertices]
    edges = np.roll(hp, -1, axis=0) - hp
    lens = np.linalg.norm(edges, axis=1)
    keep = lens > 1e-15
    dirs = edges[keep] / lens[keep, None]
    # rectangle aligned to each hull edge direction
    us = dirs
    vs = np.stack([-dirs[:, 1], dirs[:, 0]], axis=1)
    pu = hp @ us.T  # (H, E)
    pv = hp @ vs.T
    du = pu.max(axis=0) - pu.min(axis=0)
    dv = pv.max(axis=0) - pv.min(axis=0)
    areas = du * dv
    k = int(np.argmin(areas))
    return (
        float(areas[k]),
        us[k],
        vs[k],
        (pu[:, k].min(), pu[:, k].max(), pv[:, k].min(), pv[:, k].max()),
    )


def _hull(vertices: np.ndarray):
    """(hull, hull points, candidate normals): qhull's hull and its facet
    normals, deduplicated (qhull triangulates coplanar faces)."""
    hull = ConvexHull(vertices)
    hp = vertices[hull.vertices]
    normals = np.unique(np.round(hull.equations[:, :3], 6), axis=0)
    return hull, hp, normals


def search_numpy(hp: np.ndarray, normals: np.ndarray):
    """(axes rows world -> box, lo, hi) of the least-volume box over the
    candidate normals: the numpy loop, the native search's oracle."""
    best = None
    for n in normals:
        n = n / np.linalg.norm(n)
        # in-plane basis
        helper = np.eye(3)[np.argmin(np.abs(n))]
        a = np.cross(helper, n)
        a /= np.linalg.norm(a)
        b = np.cross(n, a)
        proj = hp @ np.stack([a, b], axis=1)  # (H,2)
        h = hp @ n
        area, u2, v2, (umin, umax, vmin, vmax) = _min_area_rect_2d(proj)
        depth = h.max() - h.min()
        volume = area * depth
        if best is None or volume < best[0]:
            u3 = u2[0] * a + u2[1] * b
            v3 = v2[0] * a + v2[1] * b
            axes = np.stack([u3, v3, n], axis=0)  # rows: world->obb
            lo = np.array([umin, vmin, h.min()])
            hi = np.array([umax, vmax, h.max()])
            best = (volume, axes, lo, hi)
    return best[1:]


def search_native(hp: np.ndarray, normals: np.ndarray, hull):
    """The same search in the native library, each candidate's 2D hull
    taken as the 3D hull's silhouette (shoulder_tpu/host/obb.py::
    _native_search): the simplices are remapped to hull-point indices and
    wound CCW seen from outside (qhull's winding is arbitrary; the outward
    direction is authoritative in `equations`).  Where no silhouette
    candidate gives a box, the plain native search runs."""
    inv = np.full(hull.points.shape[0], -1, np.int64)
    inv[hull.vertices] = np.arange(hull.vertices.shape[0])
    simp = inv[hull.simplices]
    eqs = hull.equations[:, :3]
    tri = hp[simp]
    winding = np.einsum(
        "ij,ij->i",
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
        eqs,
    )
    flip = winding < 0
    simp[flip] = simp[flip][:, [0, 2, 1]]
    nbr = np.array(hull.neighbors)
    nbr[flip] = nbr[flip][:, [0, 2, 1]]
    res = native.min_volume_box_silhouette(hp, simp, nbr, eqs, normals)
    if res is None:
        res = native.min_volume_box(hp, normals)
    if res is None:
        raise ValueError("no candidate normal gives a box")
    return res


def _to_obb(axes, lo, hi):
    extents = hi - lo
    center_obb = (lo + hi) / 2.0

    # sort so extents ascend (z = long axis), then enforce right-handedness
    order = np.argsort(extents)
    axes = axes[order]
    extents = extents[order]
    center_obb = center_obb[order]
    if np.linalg.det(axes) < 0:
        axes[0] *= -1.0
        center_obb[0] *= -1.0

    to_obb = np.eye(4)
    to_obb[:3, :3] = axes
    to_obb[:3, 3] = -center_obb
    return to_obb, extents


@trace.spanned("ingest.obb")
def oriented_bounds(vertices: np.ndarray):
    """Minimum-volume OBB (native search).

    Returns (to_obb (4,4), extents (3,)): `to_obb` maps mesh coordinates to
    the OBB frame (centered, axis-aligned, extents ascending x<=y<=z,
    right-handed).
    """
    hull, hp, normals = _hull(vertices)
    return _to_obb(*search_native(hp, normals, hull))


def oriented_bounds_numpy(vertices: np.ndarray):
    """oriented_bounds by the numpy loop (the oracle)."""
    _, hp, normals = _hull(vertices)
    return _to_obb(*search_numpy(hp, normals))
