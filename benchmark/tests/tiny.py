"""A cell of BENCHMARK.json run end to end on the CPU at a tiny size: the
port's plain paths against the reference, the harness's look for a card
skipped (harness/main.run_cell on the CPU)."""

import time

import torch

from benchmark.harness import main as M
from benchmark.harness import spec as S

TINY = {"max_faces": 8192, "max_verts": 6144, "max_chain": 512,
        "sphere_seg_iters": 6, "mrr_coarse_angles": 64, "mrr_fine_angles": 9,
        "segmenter": "sphere",
        "full": {"zslice_num": 64, "interp_num": 64, "band": 512},
        "proximal": {"zslice_num": 96, "interp_num": 128, "band": 512},
        "distal": {"zslice_num": 48, "interp_num": 96, "band": 512}}


def overrides(cell_name: str) -> dict:
    bench = S.load_benchmark()
    cell = S.cell(bench, cell_name)
    conf = S.config(bench, cell["config"])
    traffic = S.traffic(cell["traffic"])
    inputs = dict(conf["inputs"])
    if inputs["kind"] == "mesh":
        inputs.update(n_rings=48, n_theta=32)
        ov = {"pipeline": TINY, "inputs": inputs}
    else:
        inputs.update(shape=[96, 40, 40], pitch_mm=3.4, max_tris=60000)
        ov = {"pipeline": dict(TINY, max_faces=30000, max_verts=16000),
              "inputs": inputs}
    small = {"distinct": 4, "profile_steps": 1}
    if "batch" in traffic:
        small["batch"] = 2
    ov["traffic"] = small
    return ov


def run(cell_name: str, seconds: float = 1.0, trace: bool = False,
        seed: int = 2**33 + 17):
    torch.set_num_threads(4)
    return M.run_cell(cell_name, seed, seconds, trace, torch.device("cpu"),
                      time.perf_counter(), overrides=overrides(cell_name))
