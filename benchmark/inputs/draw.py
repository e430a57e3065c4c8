"""The inputs of a run, drawn from its seed: synthetic humeri (meshes,
written as binary STL where the mix reads files) and CT volumes.  The
same seed gives the same inputs; every seed gives inputs of the same
sizes (the mesh's rings and sectors, the volume's shape), so a seed
changes the anatomy and the pose, not the amount of work."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from benchmark.inputs.ct_volume import synth_ct_volume
from benchmark.inputs.humerus import synthetic_humerus
from benchmark.reference.frozen.io import stl

SIDES = ("left", "right")


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def mesh_params(inputs: dict, seed: int, n: int) -> list[dict]:
    """n bones' generator arguments: sides alternate, the anatomy drawn
    uniformly within the configuration's spans, each bone's rigid
    transform from its own draw."""
    rng = _rng(seed, 1)
    out = []
    for i in range(n):
        out.append(dict(
            length=float(rng.uniform(*inputs["length_mm"])),
            head_radius=float(rng.uniform(*inputs["head_radius_mm"])),
            neck_shaft_deg=float(rng.uniform(*inputs["neck_shaft_deg"])),
            retroversion_deg=float(rng.uniform(*inputs["retroversion_deg"])),
            side=SIDES[i % 2], n_rings=int(inputs["n_rings"]),
            n_theta=int(inputs["n_theta"]),
            transform_seed=int(rng.integers(2**63))))
    return out


def mesh(params: dict):
    """(vertices, faces) of one bone."""
    kw = dict(params)
    t = np.random.default_rng(kw.pop("transform_seed"))
    return synthetic_humerus(rng_transform=t, **kw)


def ct_params(inputs: dict, seed: int, n: int) -> list[dict]:
    """n volumes' generator arguments: sides alternate, retroversion and
    neck-shaft drawn within the configuration's spans, the noise from
    its own draw."""
    rng = _rng(seed, 2)
    out = []
    for i in range(n):
        out.append(dict(
            shape=tuple(inputs["shape"]),
            spacing=(float(inputs["pitch_mm"]),) * 3,
            noise_hu=float(inputs["noise_hu"]), side=SIDES[i % 2],
            retroversion_deg=float(rng.uniform(*inputs["retroversion_deg"])),
            neck_shaft_deg=float(rng.uniform(*inputs["neck_shaft_deg"])),
            seed=int(rng.integers(2**31)), **inputs["bone"]))
    return out


def ct_volumes(params: list[dict], workers: int = 4):
    """[(volume, origin, spacing)] rendered on the host, a few at once."""
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda p: synth_ct_volume(**p), params))


def write_mesh(params: dict, path: str) -> str:
    stl.write_stl(path, *mesh(params))
    return path


def write_meshes(params: list[dict], workdir) -> list[Path]:
    """Each bone's mesh as a binary STL file under `workdir`, made on
    every core."""
    from benchmark.reference.ingest_worker import pool_map

    paths = [str(Path(workdir) / f"bone_{i:03d}.stl")
             for i in range(len(params))]
    pool_map(write_mesh, list(zip(params, paths)))
    return [Path(p) for p in paths]
