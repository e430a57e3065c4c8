"""What one run of the main path costs the host: kernel launches and
synchronizing calls, counted the same way by `bench_torch.py` and by
`chip_smoke.py`'s timing phase.

The profiler counts the launch API calls (cudaLaunchKernel and the
others) but not the launches of the port's own kernels, which go through
the kernel library, so their wrappers' counters (utils/trace.py) are
added.  A CUDA graph's replay launches its kernels without the API calls
or the wrappers; `kernel_runs` counts the port's kernels that ran, by
the names a profile gives them, however they were launched.  Synchronizing calls are counted under
`torch.cuda.set_sync_debug_mode("warn")` on the second of two watched
runs: the first run so watched in a process counts one more.  Both need a CUDA device; keep them out of timed runs.
"""

from __future__ import annotations

import re
import subprocess
import time
import warnings

from shoulder_tpu_torch.utils import trace

# the kernel wrappers' launch counters
LAUNCHES = ("launches.slice_stack", "launches.slice_raw",
            "launches.chain_walk", "launches.sphere_score",
            "launches.sphere_fit")


# each launch counter's kernels, by the names csrc/ gives them
KERNELS = {"slice_stack_kernel": "launches.slice_stack",
           "slice_raw_kernel": "launches.slice_raw",
           "chain_walk_kernel": "launches.chain_walk",
           "sphere_score_kernel": "launches.sphere_score",
           "sphere_fit_kernel": "launches.sphere_fit",
           "sphere_sigma_kernel": "launches.sphere_fit"}
_KERNEL_NAME = re.compile(r"(?:^|::)(\w+_kernel)[<(]")


def reset_launches() -> None:
    """Every kernel wrapper's launch counter (utils/trace.py) set to 0."""
    trace.reset(LAUNCHES)


def launch_counts() -> tuple[int, int, int]:
    """(slice-stack, raw-loop, standalone walk) launches since
    reset_launches()."""
    return tuple(trace.counter(n) for n in LAUNCHES[:3])


def sphere_launch_counts() -> tuple[int, int]:
    """(sphere score, sphere fit) launches since reset_launches()."""
    return tuple(trace.counter(n) for n in LAUNCHES[3:])


def port_launches() -> int:
    """Every launch of the port's own kernels since reset_launches()."""
    return sum(trace.counter(n) for n in LAUNCHES)


def kernel_runs(prof) -> dict:
    """The port's kernels that ran on the card within a torch.profiler
    profile, by launch counter name (LAUNCHES), replays of CUDA graphs
    included."""
    import torch

    runs = dict.fromkeys(LAUNCHES, 0)
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and (m := _KERNEL_NAME.search(e.name))
                and m.group(1) in KERNELS):
            runs[KERNELS[m.group(1)]] += 1
    return runs


def count_launches(run) -> dict:
    """One profiled call of run(), waited for: the profiler's launch API
    calls by name (`launch_api`), the port's own kernel launches
    (`port_launches`), their sum (`launches`), the run's wall ms and the
    profiler (`prof`, for device times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    port0 = port_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    port = port_launches() - port0
    api = {e.key: e.count for e in prof.key_averages()
           if "LaunchKernel" in e.key}
    return {"launch_api": api, "port_launches": port,
            "launches": sum(api.values()) + port, "wall_ms": wall_ms,
            "prof": prof}


def count_syncs(run) -> int:
    """Synchronizing calls of run(), on the second of two runs under
    set_sync_debug_mode("warn")."""
    import torch

    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return sum("synchronizing" in str(w.message) for w in caught)


def card() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
