"""End-to-end streamed-cohort benchmark of the PyTorch port on one CUDA
card: 64 bones, host ingest included.  The twin of tools/bench_cohort.py.

Times `shoulder_tpu_torch.cohort.process_cohort` over 4 bones replicated
x16 (= 64 bones) at batch_size 8, twice: a cold pass (kernel build on
first use, models loaded), then the reported warm pass, which still
re-ingests every STL from disk.  The bones are the reference's 4 test
fixtures when SHOULDER_REFERENCE_BONES names their directory and it holds
all four, else 4 synthetic humeri written to STL (chip_smoke.py phase
4's first two left and first two right bones).  Prints the warm pass's
wall time and bones/s, the cohort summary, and the card's name and power
limit.  There is no CPU fallback: without a CUDA device main() raises.

    python3 tools/bench_cohort_torch.py [repeats_per_fixture] [batch_size]
"""

import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from shoulder_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402

FIXTURES = [
    "humerus_left.stl",
    "humerus_left_flipped.stl",
    "humerus_right.stl",
    "humerus_left_trab.stl",
]
# chip_smoke.py phase 4's bones i are synthetic_humerus(side,
# default_rng(i)) with sides left, right, left, ...: its first two left
# and first two right
SYNTHETIC = (("left", 0), ("left", 2), ("right", 1), ("right", 3))


def log(msg):
    print(f"[cohort] {msg}", flush=True)


def cohort_bones(td, bones_dir=None):
    """The 4 distinct bones' STL paths: the reference's fixtures under
    `bones_dir` (None: SHOULDER_REFERENCE_BONES) when all are there,
    else synthetic humeri written into `td`, each named
    synthetic_<side>_<seed>.stl."""
    from shoulder_tpu_torch.io import stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus

    if bones_dir is None:
        bones_dir = os.environ.get("SHOULDER_REFERENCE_BONES")
    if bones_dir:
        paths = [Path(bones_dir) / name for name in FIXTURES]
        if all(p.exists() for p in paths):
            log(f"bones: the reference's fixtures in {bones_dir}")
            return [str(p) for p in paths]
    log("bones: 4 synthetic humeri (no fixtures)")
    paths = []
    for side, seed in SYNTHETIC:
        v, f = synthetic_humerus(side=side,
                                 rng_transform=np.random.default_rng(seed))
        paths.append(os.path.join(td, f"synthetic_{side}_{seed}.stl"))
        stl.write_stl(paths[-1], v, f)
    return paths


def run_cohort(paths, device, config=DEFAULT_CONFIG, batch_size=8):
    """tools/bench_cohort.py's protocol over `paths` on `device`: a cold
    pass, then a timed warm pass.  Returns (rows, summary, warm seconds)."""
    from shoulder_tpu_torch import cohort

    log(f"{len(paths)} bones, batch_size {batch_size}")
    t0 = time.perf_counter()
    out = cohort.process_cohort(paths, config=config, batch_size=batch_size,
                                device=device)
    assert len(out) == len(paths)
    log(f"cold pass: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    out = cohort.process_cohort(paths, config=config, batch_size=batch_size,
                                device=device)
    wall = time.perf_counter() - t0
    assert len(out) == len(paths)
    log(f"warm pass: {wall:.1f} s = {len(paths) / wall:.2f} bones/s "
        f"end-to-end incl. ingest")
    stats = cohort.cohort_summary(out)
    log(f"summary: {stats}")
    return out, stats, wall


def main():
    from shoulder_tpu_torch.bone import _device
    from shoulder_tpu_torch.utils import bench

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    batch_size = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    _device("cuda")
    log(f"card: {bench.card()}")
    with tempfile.TemporaryDirectory() as td:
        paths = [p for p in cohort_bones(td) for _ in range(reps)]
        run_cohort(paths, "cuda", DEFAULT_CONFIG, batch_size)


if __name__ == "__main__":
    main()
