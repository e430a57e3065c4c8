"""Host work of the benchmark in worker processes: the reference's numpy
STL read, weld, adjacency and OBB search (about 2 s a bone on one core),
and the inputs' meshes, made on every core.  Imports no torch: a
spawned worker starts in a fraction of a second."""

from __future__ import annotations

import multiprocessing
import os

import numpy as np


def load_bone(path, cfg):
    from benchmark.reference.frozen.io import ingest

    return ingest.load_bone(path, config=cfg)


def weld_bone(tris, cfg):
    """A BoneSpec of a triangle soup (float32 (n, 3, 3)), welded and
    ingested by numpy."""
    from benchmark.reference.frozen.io import ingest, stl

    verts, faces = stl.weld(tris.astype(np.float64))
    neighbors, watertight = stl.edge_face_adjacency(faces)
    return ingest.spec_from_arrays("ct_volume", verts, faces, neighbors,
                                   watertight, config=cfg)


def pool_map(fn, arg_lists, workers: int | None = None):
    """[fn(*args) for args in arg_lists] over spawned worker processes,
    in order; the pool is closed and joined before it returns."""
    workers = min(workers or os.cpu_count() or 1, len(arg_lists))
    if workers <= 1:
        return [fn(*a) for a in arg_lists]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        out = pool.starmap(fn, arg_lists)
        pool.close()
        pool.join()
    return out
