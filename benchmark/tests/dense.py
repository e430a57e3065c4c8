"""The dense mesh cell at a small size: benchmark/tests/tiny.py's
overrides with a mesh past TINY's padding (96 x 64, 12,288 faces against
its 8,192), the padding, slots and windows raised to hold it, as
DENSE_CONFIG's are over DEFAULT_CONFIG's."""

import time

import torch

from benchmark.harness import main as M
from benchmark.tests import tiny

CELL = "mesh_unet_dense.batch8"
WINDOWS = {"full": (64, 64), "proximal": (96, 128), "distal": (48, 96)}


def overrides() -> dict:
    ov = tiny.overrides(CELL)
    ov["inputs"].update(n_rings=96, n_theta=64)
    ov["pipeline"] = dict(
        ov["pipeline"], max_faces=16384, max_verts=8192, max_chain=1024,
        slice_compact_k=1024,
        **{name: {"zslice_num": s, "interp_num": n, "band": 2048}
           for name, (s, n) in WINDOWS.items()})
    return ov


def run(device, seconds: float = 1.0, trace: bool = False,
        seed: int = 2**33 + 23):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(4)
    return M.run_cell(CELL, seed, seconds, trace, torch.device(device),
                      time.perf_counter(), overrides=overrides())
