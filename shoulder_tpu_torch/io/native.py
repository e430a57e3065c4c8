"""ctypes bindings for the port's native host ingest (csrc/ingest.cpp and
csrc/obb.cpp).

The C++ is built by g++ from shoulder_tpu_torch/csrc/ at first use, once
per build key, into shoulder_tpu_torch/_build/ingest_<key>.so.  The key
hashes the flags, both sources and the host: its CPU model and what
`-march=native` expands to there, so a library built for one CPU is never
loaded on another.  The build runs under an exclusive file lock and the
library is renamed into place when it is whole, so processes that start
together wait for one build and never load a half-written file.  A failed
build raises with the compiler's output; there is no fallback.

The flags are the JAX package's (shoulder_tpu/io/native.py):
-march=native and -fopenmp-simd vectorize the OBB search's min/max
reductions (value-exact under reordering), and -ffp-contract=off keeps g++
from contracting a * b + c into one rounding, so every scalar expression
rounds as numpy's separate operations do.

Entries (each call releases the GIL, as ctypes.CDLL calls do, so a
prefetch thread's ingest overlaps the card):
  * ingest_stl: binary STL bytes -> welded mesh + adjacency, bit for bit
    the JAX package's native path;
  * weld_soup: float32 triangles -> what stl.weld + stl.edge_face_adjacency
    give, bit for bit;
  * min_volume_box / min_volume_box_silhouette: the minimum-volume box
    search of host/obb.py.

`ingest_count` counts meshes welded here (STLs and soups), `obb_count`
box searches, so a run can show that every ingest went native.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import re
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ingest.cpp", "obb.cpp")
FLAGS = ["-O3", "-march=native", "-fopenmp-simd", "-ffp-contract=off",
         "-shared", "-fPIC", "-std=c++17"]
CXX = "g++"

ingest_count = 0
obb_count = 0

_lib = None
_count_lock = threading.Lock()


def cpu_model() -> str:
    """The host CPU's model name, as lscpu's "Model name" gives it."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _native_target() -> str:
    """What g++ makes of -march=native on this host (the target and every
    feature flag), without compiling anything."""
    try:
        proc = subprocess.run([CXX, "-march=native", "-###", "-E", "-x",
                               "c++", os.devnull], capture_output=True,
                              text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native ingest needs {CXX} on PATH") from e
    return proc.stderr


def host_cpu() -> str:
    """The host CPU as a time measured on it should name it: lscpu's model
    name, the target g++ resolves -march=native to, and the core count."""
    arch = [a for a in re.findall(r"-march=([\w.-]+)", _native_target())
            if a != "native"] or ["unknown"]
    return (f"{cpu_model()}, -march=native: {arch[-1]}, {os.cpu_count()} "
            f"cores")


def build_key(src_dir: Path = CSRC) -> str:
    """Hash over the flags, the host's CPU and both sources."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(cpu_model().encode() + b"\0" + _native_target().encode())
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (src_dir / name).read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build(src_dir: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources of `src_dir` into one shared library in
    `build_dir` (once per build key, one process at a time) and return its
    path.  A failed build raises with the compiler's output."""
    so = build_dir / f"ingest_{build_key(src_dir)}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # built by another process while this one waited
            return so
        fd, tmp = tempfile.mkstemp(prefix=so.stem + ".", suffix=".tmp",
                                   dir=build_dir)
        os.close(fd)
        try:
            cmd = [CXX, *FLAGS, *(str(src_dir / n) for n in SOURCES), "-o",
                   tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{CXX} failed to build the native ingest (rc "
                    f"{proc.returncode}):\n$ {' '.join(cmd)}\n{proc.stdout}"
                    f"{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def library():
    """The built library, loaded once per process, with every entry's
    argument types set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        mesh_out = [ptr, i32, ptr, ptr, i32, ptr]
        lib.shoulder_ingest_stl.argtypes = [ctypes.c_char_p, i64, *mesh_out]
        lib.shoulder_ingest_stl.restype = ctypes.c_int
        lib.shoulder_weld_soup.argtypes = [ptr, i64, *mesh_out]
        lib.shoulder_weld_soup.restype = ctypes.c_int
        lib.shoulder_min_volume_obb.argtypes = [ptr, i32, ptr, i32, ptr, ptr,
                                                ptr]
        lib.shoulder_min_volume_obb.restype = ctypes.c_int
        lib.shoulder_min_volume_obb_sil.argtypes = [ptr, i32, ptr, ptr, ptr,
                                                    i32, ptr, i32, ptr, ptr,
                                                    ptr]
        lib.shoulder_min_volume_obb_sil.restype = ctypes.c_int
        _lib = lib
    return _lib


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def _mesh(entry, src, n_src, n_tri: int):
    """Run a mesh entry with outputs sized for n_tri triangles (at most
    3 n_tri vertices and n_tri faces) and return (vertices float64, faces
    int64, neighbors int64, watertight)."""
    verts = np.empty((3 * n_tri, 3), np.float32)
    faces = np.empty((n_tri, 3), np.int32)
    neighbors = np.empty((n_tri, 3), np.int32)
    counts = np.zeros(3, np.int32)
    rc = entry(src, n_src, verts.ctypes.data, verts.shape[0],
               faces.ctypes.data, neighbors.ctypes.data, faces.shape[0],
               counts.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} failed with code {rc}")
    nv, nf = int(counts[0]), int(counts[1])
    return (verts[:nv].astype(np.float64), faces[:nf].astype(np.int64),
            neighbors[:nf].astype(np.int64), bool(counts[2]))


def ingest_stl(data: bytes):
    """Binary STL bytes -> (vertices, faces, neighbors, watertight), as the
    JAX package's native ingest gives them.  Raises ValueError when the
    file is shorter than its header says."""
    if len(data) < 84:
        raise ValueError(f"binary STL of {len(data)} bytes has no header")
    (n_tri,) = struct.unpack_from("<I", data, 80)
    if 84 + n_tri * 50 > len(data):
        raise ValueError(
            f"binary STL truncated: header says {n_tri} triangles "
            f"({84 + n_tri * 50} bytes) but file has {len(data)}")
    out = _mesh(library().shoulder_ingest_stl, data, len(data), n_tri)
    _count("ingest_count")
    return out


def weld_soup(triangles: np.ndarray):
    """Float32 triangles (n, 3, 3) -> (vertices, faces, neighbors,
    watertight), equal to stl.weld(triangles.astype(float64)) followed by
    stl.edge_face_adjacency: -0.0 and +0.0 weld to one vertex that keeps
    the first-seen bits, and only edges with exactly two faces pair."""
    if (triangles.dtype != np.float32 or triangles.ndim != 3
            or triangles.shape[1:] != (3, 3)):
        raise ValueError(f"weld_soup takes float32 (n, 3, 3) triangles, not "
                         f"{triangles.dtype} {triangles.shape}")
    tri = np.ascontiguousarray(triangles)
    out = _mesh(library().shoulder_weld_soup, tri.ctypes.data, tri.shape[0],
                tri.shape[0])
    _count("ingest_count")
    return out


def _f64(a, cols):
    a = np.ascontiguousarray(a, np.float64)
    if a.ndim != 2 or a.shape[1] != cols:
        raise ValueError(f"expected (n, {cols}) values, got {a.shape}")
    return a


def _box(entry, *args):
    axes = np.empty((3, 3), np.float64)
    lo = np.empty(3, np.float64)
    hi = np.empty(3, np.float64)
    rc = entry(*args, axes.ctypes.data, lo.ctypes.data, hi.ctypes.data)
    _count("obb_count")
    return None if rc != 0 else (axes, lo, hi)


def min_volume_box(hull_pts, normals):
    """(axes (3, 3) rows world -> box, lo (3,), hi (3,)) of the least-volume
    box over the candidate normals, each with the exact 2D minimum-area
    rectangle of the projected hull points; None when no candidate gives
    a box."""
    hp, nrm = _f64(hull_pts, 3), _f64(normals, 3)
    return _box(library().shoulder_min_volume_obb, hp.ctypes.data,
                hp.shape[0], nrm.ctypes.data, nrm.shape[0])


def min_volume_box_silhouette(hull_pts, simplices, neighbors, face_normals,
                              normals):
    """min_volume_box with each candidate's 2D hull taken as the 3D hull's
    silhouette: `simplices` (T, 3) index hull_pts, wound CCW seen from
    outside; neighbors[f, k] is the facet across the edge opposite vertex
    k; face_normals (T, 3) point outward.  The same box as min_volume_box
    on the same hull; None when no candidate gives a box."""
    hp, nrm, fn = (_f64(hull_pts, 3), _f64(normals, 3),
                   _f64(face_normals, 3))
    simp = np.ascontiguousarray(simplices, np.int32)
    nbr = np.ascontiguousarray(neighbors, np.int32)
    n_t = fn.shape[0]
    if simp.shape != (n_t, 3) or nbr.shape != (n_t, 3):
        raise ValueError("simplices, neighbors and face_normals differ in "
                         "shape")
    if n_t and (simp.min() < 0 or simp.max() >= hp.shape[0]):
        raise ValueError("a simplex indexes outside the hull points")
    return _box(library().shoulder_min_volume_obb_sil, hp.ctypes.data,
                hp.shape[0], simp.ctypes.data, nbr.ctypes.data, fn.ctypes.data,
                n_t, nrm.ctypes.data, nrm.shape[0])
