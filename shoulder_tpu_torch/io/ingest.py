"""Host-side bone ingest: STL -> padded tensors + canonical OBB orientation.

Covers the reference's MeshLoader/FullObb/ProxObb layer
(reference mesh.py:14-192):
  * FullObb: min-volume OBB, then head-end detection by circle-fit residual
    of a slice near each end, flipping with diag(-1,1,-1) so the humeral
    head is +z (mesh.py:82-125).
  * ProxObb: OBB, head end = largest cross-section area over 100 z-stations,
    canal window = longest run where the smoothed area gradient < 10
    (mesh.py:133-192).

Everything here is one-time per bone on the host; the result is a BoneSpec
of fixed-shape arrays ready to batch and ship to the device pipeline.  The
STL read, weld and adjacency (io/stl.load_indexed) and the OBB search
(host/obb.oriented_bounds) run in the port's native library
(io/native.py); head detection (`_head_end`) and the presort
(`_presort_faces`) are numpy.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import scipy.signal

from shoulder_tpu_torch import config as config_mod
from shoulder_tpu_torch.config import PipelineConfig
from shoulder_tpu_torch.host import obb as obb_host
from shoulder_tpu_torch.host import slicing_np
from shoulder_tpu_torch.io import stl
from shoulder_tpu_torch.utils import trace

_FLIP = np.diag([-1.0, 1.0, -1.0, 1.0])


@dataclasses.dataclass
class BoneSpec:
    """One ingested bone: padded mesh tensors + OBB orientation metadata."""

    name: str
    vertices: np.ndarray        # (max_verts, 3) f32, padded
    faces: np.ndarray           # (max_faces, 3) i32, padding rows = [0,0,0]
    neighbors: np.ndarray       # (max_faces, 3) i32, -1 where boundary/pad
    n_verts: int
    n_faces: int
    obb_transform: np.ndarray   # (4,4) f64 CT -> OBB (flip included)
    extents: np.ndarray         # (3,) OBB extents, ascending
    z_bounds: tuple             # (z_min, z_max) in OBB frame
    z_length: float
    cutoff_pcts: tuple          # canal window (ProxObb-derived or default)
    watertight: bool
    proximal: bool

    # unpadded views for host-side work (original STL face order)
    vertices_raw: np.ndarray = None
    faces_raw: np.ndarray = None
    neighbors_raw: np.ndarray = None

    # faces/neighbors above are pre-sorted by OBB-frame face z_min (the
    # slice kernels' window order — a pure function of ingest-known data,
    # lifted off the device hot path); face_orig[i] is slot i's original
    # STL face index, which keeps loop-start selection and therefore every
    # contour identical to the unsorted formulation
    face_orig: np.ndarray = None

    # the config the bone was padded for, at which its landmarks run
    config: PipelineConfig = None


def _pad(arr, n, fill):
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


@trace.spanned("ingest.presort")
def _presort_faces(verts_p, faces_p, neighbors_p, to_obb):
    """Reorder padded faces by OBB-frame z_min (lexicographic with the
    original face index as tie-break — matching the device kernel's
    lax.sort key).  Neighbor ids are remapped into the sorted frame;
    face_orig maps each sorted slot back to its original index.

    The z values here are computed in float32 from the float32-padded
    vertices so the order matches what the device would compute; sub-ulp
    disagreements near ties are absorbed by the kernel's conservative
    monotone search key (ops/slicing.SortedGeom.z_key).
    """
    t32 = to_obb.astype(np.float32)
    z_obb = verts_p @ t32[2, :3] + t32[2, 3]
    z_tri = z_obb[faces_p]
    z_min = z_tri.min(axis=1)
    degenerate = (faces_p[:, 0] == faces_p[:, 1]) & (
        faces_p[:, 1] == faces_p[:, 2]
    )
    z_min[degenerate] = np.inf
    n = faces_p.shape[0]
    idx = np.arange(n)
    order = np.lexsort((idx, z_min)).astype(np.int32)
    inv = np.empty(n, np.int32)
    inv[order] = np.arange(n, dtype=np.int32)
    nbr = neighbors_p[order]
    nbr_s = np.where(nbr >= 0, inv[np.clip(nbr, 0, n - 1)], -1).astype(
        np.int32
    )
    return faces_p[order], nbr_s, order


def _section_points(verts, faces, neighbors, z):
    loops = slicing_np.cross_section(verts, faces, neighbors, z)
    if not loops:
        return np.zeros((0, 2))
    return np.concatenate([l["points"] for l in loops], axis=0)


def _circle_residual(pts2d):
    """Kasa least-squares circle residual (reference mesh.py:102 uses
    circle_fit.least_squares_circle whose residual is sum of squared radial
    deviations)."""
    x, y = pts2d[:, 0], pts2d[:, 1]
    a = np.stack([x, y, np.ones_like(x)], axis=1)
    b = x**2 + y**2
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    cx, cy = sol[0] / 2.0, sol[1] / 2.0
    r = np.sqrt(sol[2] + cx**2 + cy**2)
    dist = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    return float(np.sum((dist - r) ** 2))


def _consecutive(arr):
    """Longest run of consecutive indices (reference mesh.py:140-141)."""
    return max(
        np.split(arr, np.flatnonzero(np.diff(arr) != 1) + 1), key=len
    )


@trace.spanned("ingest.head")
def _head_end(verts, faces, neighbors, z_min, z_max, proximal, config):
    """(flip, cutoff_pcts): whether the humeral head lies at -z in the OBB
    frame (numpy cross-sections of the mesh, host/slicing_np.py), and the
    canal window."""
    cutoff_pcts = tuple(config.full_obb_cutoff_pcts)
    if not proximal:
        # head-end detection via circle-fit residual (mesh.py:89-117)
        best = (np.inf, 0.0)
        for z_limit in (z_min, z_max):
            pts = _section_points(
                verts, faces, neighbors, config.head_probe_inset * z_limit
            )
            residu = _circle_residual(pts)
            if residu < best[0]:
                best = (residu, z_limit)
        flip = best[1] < 0
    else:
        # head end = largest area over z stations (mesh.py:150-167)
        n_st = config.prox_area_stations
        z_stations = np.linspace(
            z_min * config.prox_area_inset, z_max * config.prox_area_inset, n_st
        )
        z_area = np.array(
            [
                slicing_np.section_area(verts, faces, neighbors, z)
                for z in z_stations
            ]
        )
        flip = z_stations[int(np.argmax(z_area))] < 0
        if flip:
            z_area = z_area[::-1]
        # canal window from smoothed area gradient (mesh.py:182-190)
        grad = np.gradient(scipy.signal.savgol_filter(z_area, 3, 1))
        canal_zs = _consecutive(np.flatnonzero(grad < config.prox_grad_threshold))
        cutoff_pcts = (canal_zs[0] / n_st, canal_zs[-1] / n_st)
    return flip, cutoff_pcts


def load_bone(
    path,
    proximal: bool = False,
    config: PipelineConfig | None = None,
) -> BoneSpec:
    """`spec_from_arrays` of an STL file."""
    path = Path(path)
    verts_ct, faces, neighbors, watertight = stl.load_indexed(path)
    return spec_from_arrays(
        path.stem, verts_ct, faces, neighbors, watertight,
        proximal=proximal, config=config,
    )


@trace.spanned("ingest.spec")
def spec_from_arrays(
    name: str,
    verts_ct,
    faces,
    neighbors,
    watertight: bool,
    proximal: bool = False,
    config: PipelineConfig | None = None,
) -> BoneSpec:
    """Build a BoneSpec from an already-indexed mesh (STL path, CT surface
    extraction, or any in-memory mesh), padded to `config`, or with none,
    to the smallest padding that holds it (`config.by_size`)."""
    if config is None:
        config = config_mod.by_size(faces.shape[0], verts_ct.shape[0])
    to_obb, extents = obb_host.oriented_bounds(verts_ct)
    verts = verts_ct @ to_obb[:3, :3].T + to_obb[:3, 3]
    z_min, z_max = float(verts[:, 2].min()), float(verts[:, 2].max())

    flip, cutoff_pcts = _head_end(verts, faces, neighbors, z_min, z_max,
                                  proximal, config)
    if flip:
        to_obb = _FLIP @ to_obb
        verts = verts_ct @ to_obb[:3, :3].T + to_obb[:3, 3]

    # reference z_length = |z_min| + |z_max| (mesh.py:86,148)
    z_length = abs(z_min) + abs(z_max)

    if faces.shape[0] > config.max_faces or verts_ct.shape[0] > config.max_verts:
        raise ValueError(
            f"{name}: mesh exceeds configured padding "
            f"({faces.shape[0]} faces / {verts_ct.shape[0]} verts)"
        )

    faces_p = _pad(faces.astype(np.int32), config.max_faces, 0)
    neighbors_p = _pad(neighbors.astype(np.int32), config.max_faces, -1)
    verts_p = _pad(verts_ct.astype(np.float32), config.max_verts, 0.0)
    faces_s, neighbors_s, face_orig = _presort_faces(
        verts_p, faces_p, neighbors_p, to_obb
    )

    return BoneSpec(
        name=name,
        vertices=verts_p,
        faces=faces_s,
        neighbors=neighbors_s,
        face_orig=face_orig,
        n_verts=verts_ct.shape[0],
        n_faces=faces.shape[0],
        obb_transform=to_obb,
        extents=extents,
        z_bounds=(z_min, z_max),
        z_length=z_length,
        cutoff_pcts=cutoff_pcts,
        watertight=watertight,
        proximal=proximal,
        vertices_raw=verts_ct,
        faces_raw=faces,
        neighbors_raw=neighbors,
        config=config,
    )
