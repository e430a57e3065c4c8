"""Profile the PyTorch port's batch pipeline on one CUDA card.

Builds the same 8 synthetic humeri as chip_smoke.py, warms up, then runs
one batch at DEFAULT_CONFIG under torch.profiler with a named range
around each pipeline stage.  The pipeline runs each stage once per batch
over the leading bone dimension, so each range is entered once per batch
(a slice-stack launch three times).  Prints the batch wall time, the device's
busy and idle share over it, host time and kernel time per stage (and
per range inside sphere_segment: its scoring, fits, sigmas and rim), the
top kernels by device time, and the host's launches and waits; with
--trace, writes the Chrome trace (tens of MB).

The profiler traces the kernels of ops/kernels.py's library on the card
but neither counts their launches as cudaLaunchKernel nor ties them to
their host range (PyTorch 2.11 on an H100; linking the library against
the shared CUDA runtime did not change that).  So the launch count adds
the wrappers' own counts, and the wrappers' ranges take their kernels'
device time by name.

Run (on a machine with a card):
  python3 tools/profile_torch_batch.py [--batch 8] [--trace PATH]
"""

import argparse
import functools
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

STAGES = ("slice_stack_kernel", "slice_raw_kernel", "_compact_slice",
          "_post_walk",
          "chain_walk_marked", "sorted_geom", "_surgical_neck", "_canal",
          "_groove", "_anp_image_points", "segment_image", "sphere_segment",
          "_anp_from_mask", "_transepicondylar", "_metrics")
# the ranges inside models/segment.sphere_segment (entered only while a
# profiler records): the hypotheses and their scoring, the seed fits and
# the IRLS passes, the basin sigmas and the refined sphere's residuals,
# and the rim cut with the support gate
SPHERE_RANGES = ("sphere_segment.score", "sphere_segment.fit",
                 "sphere_segment.sigma", "sphere_segment.rim")
RANGES = STAGES + SPHERE_RANGES
# the library's kernels (csrc/) that each range launches, by the name the
# trace gives them
OWN_KERNELS = {
    "slice_stack_kernel": ("slice_stack_kernel",),
    "slice_raw_kernel": ("slice_raw_kernel",),
    "chain_walk_marked": ("chain_walk_kernel",),
    "sphere_segment": ("sphere_score_kernel", "sphere_fit_kernel",
                       "sphere_sigma_kernel"),
    "sphere_segment.score": ("sphere_score_kernel",),
    "sphere_segment.fit": ("sphere_fit_kernel",),
    "sphere_segment.sigma": ("sphere_sigma_kernel",),
}


def _ranged(name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _instrument():
    """Wrap each stage of pipeline/landmarks.py in a profiler range."""
    from shoulder_tpu_torch.models import segment, unet
    from shoulder_tpu_torch.ops import chain_walk, slicing
    from shoulder_tpu_torch.pipeline import landmarks as L

    owner = {"slice_stack_kernel": slicing, "slice_raw_kernel": slicing,
             "_compact_slice": slicing,
             "_post_walk": slicing, "sorted_geom": slicing,
             "chain_walk_marked": chain_walk,
             "segment_image": unet, "sphere_segment": segment}
    for name in STAGES:
        mod = owner.get(name, L)
        setattr(mod, name, _ranged(name, getattr(mod, name)))


def _busy_ms(prof):
    """Union of device kernel and copy intervals (ms): the time the card
    was busy.  The stage ranges' device-side annotations are left out."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.name not in RANGES
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--trace", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_batch: needs a CUDA card")

    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.models import forest, unet
    from shoulder_tpu_torch.pipeline import batch as B

    _instrument()
    dev = torch.device("cuda:0")
    specs = []
    with tempfile.TemporaryDirectory() as td:
        for i in range(args.batch):
            v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                     rng_transform=np.random.default_rng(i))
            p = os.path.join(td, f"b{i}.stl")
            stl.write_stl(p, v, f)
            specs.append(ingest.load_bone(p))
    bones = B.stack_bones(specs, dev)
    rf, seg = forest.load_params(dev), unet.load_model(dev)

    def run():
        B.compute_landmarks_batch(bones, rf, seg_model=seg)
        torch.cuda.synchronize()

    for _ in range(3):
        run()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    print("unprofiled batch ms:", ", ".join(f"{w:.1f}" for w in walls))

    from shoulder_tpu_torch.utils import bench

    port0 = bench.port_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    port = bench.port_launches() - port0
    busy = _busy_ms(prof)
    print(f"profiled batch of {args.batch}: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}")

    avgs = prof.key_averages()
    kernels = sorted((e for e in avgs
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.key not in RANGES),
                     key=lambda e: -e.self_device_time_total)
    # the library's kernels are not tied to their host range (docstring):
    # their device time is added to their range's by kernel name
    own_us = {stage: sum(e.self_device_time_total for e in kernels
                         if any(f"::{k}" in e.key for k in names))
              for stage, names in OWN_KERNELS.items()}
    print("\nstage ranges (per batch): calls, host ms, kernel ms")
    for e in sorted((e for e in avgs if e.key in RANGES
                     and e.cpu_time_total > 0),
                    key=lambda e: -e.cpu_time_total):
        dev_us = e.device_time_total + own_us.get(e.key, 0.0)
        print(f"  {e.key:22s} {e.count:5d} {e.cpu_time_total / 1e3:9.1f} "
              f"{dev_us / 1e3:9.2f}")
    total_launch = sum(e.count for e in kernels)
    print(f"\ndevice ops: {total_launch} launches, "
          f"{sum(e.self_device_time_total for e in kernels) / 1e3:.1f} ms; "
          f"top 15 by device time")
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x  "
              f"{e.key[:90]}")
    print("the port's own kernels (csrc/), as the trace names them:")
    for e in kernels:
        if any(f"::{k}" in e.key for names in OWN_KERNELS.values()
               for k in names):
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  "
                  f"{e.key[:90]}")
    syncs = {e.key: e.count for e in avgs if e.key in (
        "aten::_local_scalar_dense", "aten::nonzero", "cudaStreamSynchronize",
        "cudaMemcpyAsync", "cudaLaunchKernel")}
    print(f"\nhost waits and launches: {syncs}")
    n_launch = syncs.get("cudaLaunchKernel", 0)
    print(f"kernel launches per batch of {args.batch}: {n_launch + port} "
          f"({n_launch} cudaLaunchKernel and {port} launches of the port's "
          f"library), {(n_launch + port) / args.batch:.1f} per bone")
    print("top 10 host ops by self CPU time")
    for e in sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  {e.self_cpu_time_total / 1e3:8.2f} ms {e.count:6d}x  "
              f"{e.key[:90]}")
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
        print(f"\ntrace: {args.trace}")


if __name__ == "__main__":
    main()
