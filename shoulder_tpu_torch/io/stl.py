"""First-party STL reader/writer (host-side numpy).

Replaces the reference's trimesh.load_mesh (reference mesh.py:24).  Handles
binary and ASCII STL, welds duplicate vertices into an indexed (V,3)/(F,3)
representation, and checks watertightness (every edge shared by exactly two
faces), mirroring the reference's is_watertight warning (mesh.py:25-27).

`load_indexed` reads binary STL through the port's native ingest
(io/native.py), as the JAX package does with its own; the numpy functions
here (`load_indexed_numpy`, `weld`, `edge_face_adjacency`) are its oracle
and read ASCII STL.
"""

from __future__ import annotations

import struct
import warnings
from pathlib import Path

import numpy as np

from shoulder_tpu_torch.io import native
from shoulder_tpu_torch.utils import trace


def _parse_binary(data: bytes):
    (n_tri,) = struct.unpack_from("<I", data, 80)
    expected = 84 + n_tri * 50
    if len(data) < expected:
        raise ValueError(
            f"binary STL truncated: header says {n_tri} triangles "
            f"({expected} bytes) but file has {len(data)}"
        )
    rec = np.frombuffer(data, dtype=np.uint8, count=n_tri * 50, offset=84)
    rec = rec.reshape(n_tri, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
    return tri.astype(np.float64)


def _parse_ascii(text: str):
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    tri = np.asarray(verts, dtype=np.float64)
    if tri.size == 0 or tri.shape[0] % 3 != 0:
        raise ValueError("malformed ASCII STL")
    return tri.reshape(-1, 3, 3)


def _is_ascii(data: bytes) -> bool:
    """A file is ASCII STL iff it starts with 'solid' AND is not a valid
    binary layout (some binary exporters also write 'solid' in the
    header)."""
    if data[:5].lower() != b"solid":
        return False
    if len(data) >= 84:
        (n_tri,) = struct.unpack_from("<I", data, 80)
        if 84 + n_tri * 50 == len(data):
            return False
    return True


def read_stl(path) -> np.ndarray:
    """Read an STL file; returns triangle soup of shape (F, 3, 3)."""
    data = Path(path).read_bytes()
    if _is_ascii(data):
        return _parse_ascii(data.decode("ascii", errors="ignore"))
    return _parse_binary(data)


def weld(triangles: np.ndarray, decimals: int | None = None):
    """Weld a triangle soup into indexed (vertices, faces).

    Exact-coordinate welding by default (STL exporters repeat identical
    float bit patterns for shared vertices).
    """
    pts = triangles.reshape(-1, 3)
    if decimals is not None:
        key = np.round(pts, decimals)
    else:
        key = pts
    _, index, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    vertices = pts[index]
    faces = inverse.reshape(-1, 3).astype(np.int64)
    # drop degenerate faces (repeated vertex indices)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 2] != faces[:, 0])
    )
    return vertices, faces[ok]


def edge_face_adjacency(faces: np.ndarray):
    """Per-face neighbor map across each of the 3 edges.

    Returns (neighbors (F,3) int64, watertight bool).  neighbors[f, k] is the
    face sharing edge (faces[f,k], faces[f,(k+1)%3]), or -1 on boundary.
    This adjacency drives the contour-chaining in the slice kernel.
    """
    f = faces
    n_faces = f.shape[0]
    edges = np.stack(
        [
            np.stack([f[:, 0], f[:, 1]], axis=1),
            np.stack([f[:, 1], f[:, 2]], axis=1),
            np.stack([f[:, 2], f[:, 0]], axis=1),
        ],
        axis=1,
    ).reshape(-1, 2)  # (3F, 2) in (face, edge-slot) order
    key = np.sort(edges, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    sorted_key = key[order]
    same_as_prev = np.all(sorted_key[1:] == sorted_key[:-1], axis=1)
    # group boundaries
    group_start = np.concatenate([[True], ~same_as_prev])
    group_id = np.cumsum(group_start) - 1
    counts = np.bincount(group_id)
    watertight = bool(np.all(counts == 2))

    neighbors = np.full(3 * n_faces, -1, dtype=np.int64)
    # for groups of exactly two, pair them up
    starts = np.flatnonzero(group_start)
    two = counts == 2
    s2 = starts[two]
    a = order[s2]
    b = order[s2 + 1]
    neighbors[a] = b // 3
    neighbors[b] = a // 3
    return neighbors.reshape(n_faces, 3), watertight


def load_indexed_numpy(path, warn_not_watertight: bool = True):
    """Load an STL into (vertices, faces, neighbors, watertight) with
    numpy: the native ingest's oracle, and the reader of ASCII STL."""
    tri = read_stl(path)
    vertices, faces = weld(tri)
    neighbors, watertight = edge_face_adjacency(faces)
    if warn_not_watertight and not watertight:
        warnings.warn(f"{Path(path).stem} is not watertight!")
    return vertices, faces, neighbors, watertight


@trace.spanned("ingest.read_weld")
def load_indexed(path, warn_not_watertight: bool = True):
    """Load an STL into (vertices, faces, neighbors, watertight).

    Binary STL goes through the native ingest (io/native.py), which gives
    what the JAX package's native path gives, bit for bit; ASCII STL is
    read by `load_indexed_numpy`.
    """
    data = Path(path).read_bytes()
    if _is_ascii(data):
        return load_indexed_numpy(path, warn_not_watertight)
    vertices, faces, neighbors, watertight = native.ingest_stl(data)
    if warn_not_watertight and not watertight:
        warnings.warn(f"{Path(path).stem} is not watertight!")
    return vertices, faces, neighbors, watertight


def write_stl(path, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a binary STL (used by tests and synthetic data generation)."""
    tri = vertices[faces].astype(np.float32)  # (F,3,3)
    n = tri.shape[0]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    normals = np.cross(v1 - v0, v2 - v0)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = np.where(lens > 0, normals / np.maximum(lens, 1e-30), 0.0).astype(
        np.float32
    )
    rec = np.zeros((n, 50), dtype=np.uint8)
    rec[:, 0:12] = normals.view(np.uint8).reshape(n, 12)
    rec[:, 12:48] = tri.reshape(n, 9).view(np.uint8).reshape(n, 36)
    with open(path, "wb") as fh:
        fh.write(b"shoulder_tpu".ljust(80, b"\0"))
        fh.write(struct.pack("<I", n))
        fh.write(rec.tobytes())
