"""Headline benchmark of the PyTorch port: bones/sec through the full
landmark pipeline on one CUDA card.  The twin of bench.py.

    python3 bench_torch.py            (BENCH_BATCH=8, BENCH_REPS=5)

Prints ONE JSON line last, with bench.py's keys:
  {"metric": ..., "value": N, "unit": "bones/sec", "vs_baseline": N}

Protocol (bench.py's): ingest the reference's humerus_left.stl when
SHOULDER_REFERENCE_BONES names the directory of the reference's test
bones and it holds that file, else a synthetic humerus written to STL;
replicate it to a batch on the card; load the forest and the UNet once;
run compute_landmarks_batch at DEFAULT_CONFIG (600x512 proximal, 200x100
full and 200x500 distal stacks, forest groove classifier, UNet-seeded
articular segmentation, transepicondylar rectangle, all metrics) once
untimed, then count one run's kernel launches and synchronizing calls
(utils/bench.py, as chip_smoke.py's timing phase counts them), then time
BENCH_REPS runs, each ended by torch.cuda.synchronize().  The means of
neck-shaft, head radius and retroversion are computed on the card and
copied once, after the timing, for bench.py's sanity gate; a build that
fails it posts 0.0.  Logs go to stderr.

There is no CPU fallback: without a CUDA device main() raises.  The
tests call run_bench(device="cpu", ...) at small sizes.
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from shoulder_tpu_torch.config import DEFAULT_CONFIG

ROOT = Path(__file__).resolve().parent

# the denominator bench.py uses: the JAX package's own XLA-CPU build of
# this pipeline on one CPU core, 2.1 s per bone (BASELINE.md).  A CPU
# time of the reference implementation's stand-in, not a time of any
# accelerator.
BASELINE_CPU_SEC_PER_BONE = 2.1
BATCH = int(os.environ.get("BENCH_BATCH", "8"))
REPS = int(os.environ.get("BENCH_REPS", "5"))
FIXTURE = "humerus_left.stl"
GOLDENS = ROOT / "tests" / "goldens_fixtures.json"
# bench.py's gates: against the fixture's golden row, or anatomy ranges
GOLDEN_TOL = 0.75
NECKSHAFT_RANGE = (110.0, 160.0)
RADIUS_RANGE = (15.0, 35.0)
METRIC = "full landmark pipeline throughput"


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def fixture_path(bones_dir=None):
    """The reference's humerus_left.stl under `bones_dir` (None: the
    SHOULDER_REFERENCE_BONES environment variable), or None when absent."""
    if bones_dir is None:
        bones_dir = os.environ.get("SHOULDER_REFERENCE_BONES")
    if not bones_dir:
        return None
    path = Path(bones_dir) / FIXTURE
    return path if path.exists() else None


def bench_bone(cfg=DEFAULT_CONFIG, bones_dir=None):
    """bench.py's bone, ingested by the port: (BoneSpec, fixture?).  The
    fixture when present, else synthetic_humerus(default_rng(0)) through
    a temporary STL."""
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus

    path = fixture_path(bones_dir)
    if path is not None:
        log(f"bone: the fixture {path}")
        return ingest.load_bone(path, config=cfg), True
    log("bone: synthetic_humerus(default_rng(0)) (no fixture)")
    v, f = synthetic_humerus(rng_transform=np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "bone.stl")
        stl.write_stl(p, v, f)
        return ingest.load_bone(p, config=cfg), False


def batch_means(lm):
    """Means of neck-shaft, head radius and retroversion over the batch,
    on the batch's device, in one tensor."""
    return torch.stack([torch.nanmean(lm.neckshaft),
                        torch.nanmean(lm.radius_curvature),
                        torch.nanmean(lm.retroversion)])


def sane(ns, rad, retro, fixture):
    """bench.py's gate: within GOLDEN_TOL of the fixture's golden row, or
    the synthetic bone's anatomy ranges."""
    if fixture:
        gold = json.loads(GOLDENS.read_text())[FIXTURE]
        return (abs(ns - gold["neckshaft"]) < GOLDEN_TOL
                and abs(rad - gold["radius_curvature"]) < GOLDEN_TOL
                and abs(retro - gold["retroversion"]) < GOLDEN_TOL)
    return (NECKSHAFT_RANGE[0] < ns < NECKSHAFT_RANGE[1]
            and RADIUS_RANGE[0] < rad < RADIUS_RANGE[1])


def result_line(p50_s, batch, ok):
    """bench.py's last line."""
    if not ok:
        return {"metric": f"{METRIC} (INSANE OUTPUT)", "value": 0.0,
                "unit": "bones/sec", "vs_baseline": 0.0}
    bones_per_sec = batch / p50_s
    return {"metric": (f"{METRIC}, batch={batch}, p50 latency "
                       f"{p50_s * 1e3:.1f} ms/batch"),
            "value": round(bones_per_sec, 2), "unit": "bones/sec",
            "vs_baseline": round(bones_per_sec * BASELINE_CPU_SEC_PER_BONE,
                                 1)}


def run_bench(device, cfg=DEFAULT_CONFIG, batch=BATCH, reps=REPS,
              bones_dir=None, out=sys.stdout):
    """bench.py's protocol on `device`; prints the result line to `out`
    last and returns {"line", "rep_ms", "p50_ms", "means", "runs",
    "launches", "launch_api", "port_launches", "syncs"}: `runs` batch
    runs in all, the warm-up and counted ones included.  Launches and
    synchronizing calls are counted on a CUDA device only (None
    elsewhere)."""
    from shoulder_tpu_torch.bone import _device
    from shoulder_tpu_torch.models import forest, unet
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.utils import bench

    dev = _device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    spec, fixture = bench_bone(cfg, bones_dir)
    t0 = time.perf_counter()
    bones = B.stack_bones([spec] * batch, dev)
    rf = forest.load_params(dev)
    seg = unet.load_model(dev) if cfg.segmenter == "unet" else None
    sync()
    log(f"upload and models {time.perf_counter() - t0:.2f} s")

    def call():
        return B.compute_landmarks_batch(bones, rf, cfg=cfg, chunk=150,
                                         seg_model=seg)

    t0 = time.perf_counter()
    call()
    sync()
    log(f"first run (kernel build on first use) "
        f"{time.perf_counter() - t0:.2f} s")

    counted = {"launches": None, "launch_api": None, "port_launches": None,
               "syncs": None}
    if cuda:
        launched = bench.count_launches(call)
        counted.update({key: launched[key] for key in
                        ("launches", "launch_api", "port_launches")})
        counted["syncs"] = bench.count_syncs(call)
        log(f"one run: {counted['launches']} kernel launches "
            f"({counted['launch_api']}, plus {counted['port_launches']} of "
            f"the port's kernels), {counted['syncs']} synchronizing calls")

    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        lm = call()
        sync()
        lat.append(time.perf_counter() - t0)
    p50 = float(np.median(lat))
    log("exec per-rep ms: " + ", ".join(f"{t * 1e3:.1f}" for t in lat)
        + f"; spread {min(lat) * 1e3:.1f}-{max(lat) * 1e3:.1f} ms; p50 "
        f"{p50 * 1e3:.1f} ms/batch of {batch}")

    ns, rad, retro = (float(x) for x in batch_means(lm).cpu())
    ok = sane(ns, rad, retro, fixture)
    log(f"means: neck-shaft {ns:.3f}, radius {rad:.3f}, retroversion "
        f"{retro:.3f}; gate {'passed' if ok else 'FAILED'}")
    line = result_line(p50, batch, ok)
    print(json.dumps(line), file=out, flush=True)
    return {"line": line, "rep_ms": [t * 1e3 for t in lat],
            "p50_ms": p50 * 1e3, "means": (ns, rad, retro),
            "runs": 1 + (3 if cuda else 0) + reps, **counted}


def main():
    from shoulder_tpu_torch.bone import _device
    from shoulder_tpu_torch.utils import bench

    _device("cuda")
    log(f"card: {bench.card()}")
    run_bench("cuda", DEFAULT_CONFIG, BATCH, REPS)


if __name__ == "__main__":
    main()
