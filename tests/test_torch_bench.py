"""The port's measurement entry points, bench_torch.py and
tools/bench_cohort_torch.py, on the CPU at small sizes.

Both run on the card when a user calls them (main() has no CPU
fallback); here their functions are called with device="cpu" and
tiny_config() explicitly.  The bench bone's ingest is held bit for bit
against the JAX package's, as bench.py ingests it.
"""

import importlib.util
import io
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from shoulder_tpu.io import ingest as jax_ingest
from shoulder_tpu.io import stl as jax_stl
from shoulder_tpu.io.testdata import synthetic_humerus as jax_synthetic
from shoulder_tpu_torch import cohort
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.io import stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.utils import bench
from test_torch_host import _build_native_ingest_once

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"metric", "value", "unit", "vs_baseline"}
# the bench bone has 40,960 faces
BENCH_CFG = tiny_config(max_faces=40960, max_verts=24576)


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_torch = _load("bench_torch.py")
bench_cohort = _load("tools/bench_cohort_torch.py")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench_spec():
    _build_native_ingest_once()
    spec, fixture = bench_torch.bench_bone(BENCH_CFG, bones_dir="")
    assert not fixture
    return spec


def _last_line(buf):
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_bench_bone_ingest_matches_jax_package(tmp_path, bench_spec):
    """The synthetic bench bone through the port's ingest is bit for bit
    the JAX package's ingest of the STL bench.py writes."""
    v, f = jax_synthetic(rng_transform=np.random.default_rng(0))
    path = tmp_path / "bone.stl"
    jax_stl.write_stl(path, v, f)
    ref = jax_ingest.load_bone(path, config=BENCH_CFG)
    for name in ("vertices", "faces", "neighbors", "face_orig",
                 "obb_transform", "z_bounds"):
        assert np.array_equal(getattr(bench_spec, name),
                              getattr(ref, name)), name


def test_bench_line_on_cpu():
    """bench.py's four keys, a positive value, vs_baseline = value x 2.1
    to the rounding of both, and the sanity gate passed."""
    buf = io.StringIO()
    res = bench_torch.run_bench("cpu", BENCH_CFG, batch=2, reps=1,
                                bones_dir="", out=buf)
    line = _last_line(buf)
    assert line == res["line"]
    assert set(line) == KEYS
    assert line["unit"] == "bones/sec"
    assert line["value"] > 0
    assert "INSANE" not in line["metric"] and "batch=2" in line["metric"]
    assert abs(line["vs_baseline"]
               - line["value"] * bench_torch.BASELINE_CPU_SEC_PER_BONE) \
        <= 0.05 + 0.005 * bench_torch.BASELINE_CPU_SEC_PER_BONE
    assert line["value"] == pytest.approx(2e3 / res["p50_ms"], abs=0.005)
    assert len(res["rep_ms"]) == 1 and res["runs"] == 2
    # launches and syncs are counted on the card only
    assert res["launches"] is None and res["syncs"] is None


def test_bench_gate_failure_posts_zero(monkeypatch, bench_spec):
    """Means outside bench.py's ranges print its INSANE line, value 0.0."""
    monkeypatch.setattr(bench_torch, "bench_bone",
                        lambda cfg, bones_dir: (bench_spec, False))
    monkeypatch.setattr(bench_torch, "batch_means",
                        lambda lm: torch.tensor([90.0, 24.0, 25.0]))
    buf = io.StringIO()
    bench_torch.run_bench("cpu", BENCH_CFG, batch=1, reps=1, out=buf)
    line = _last_line(buf)
    assert set(line) == KEYS
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert line["metric"].endswith("(INSANE OUTPUT)")


@pytest.mark.parametrize("script", ["bench_torch", "bench_cohort_torch"])
def test_entry_points_raise_without_cuda(monkeypatch, script):
    """main() asks for the card and raises without one, before any
    ingest: nothing falls back to the CPU."""
    mod = bench_torch if script == "bench_torch" else bench_cohort
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", [script])

    def no_fallback(*args, **kwargs):
        raise AssertionError("fell back to the CPU")

    monkeypatch.setattr(mod, "bench_bone" if mod is bench_torch
                        else "cohort_bones", no_fallback)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


def test_cohort_on_cpu(tmp_path):
    """Two small synthetic STLs, a cold and a warm pass: one row per
    path, sides right, and the summary of those rows."""
    paths = []
    for i, side in enumerate(("left", "right")):
        v, f = synthetic_humerus(side=side, n_rings=40, n_theta=32,
                                 rng_transform=np.random.default_rng(i))
        paths.append(str(tmp_path / f"{side}.stl"))
        stl.write_stl(paths[-1], v, f)
    rows, stats, wall = bench_cohort.run_cohort(paths, "cpu", tiny_config(),
                                                batch_size=2)
    assert len(rows) == len(paths) and wall > 0
    assert [r["name"] for r in rows] == ["left", "right"]
    assert stats == cohort.cohort_summary(rows)
    assert stats["n"] == 2


def test_cohort_synthetic_bones(tmp_path):
    """Without the fixtures the cohort takes chip_smoke.py phase 4's
    first two left and first two right bones, named by side and seed."""
    paths = bench_cohort.cohort_bones(str(tmp_path), bones_dir="")
    assert [Path(p).name for p in paths] == [
        "synthetic_left_0.stl", "synthetic_left_2.stl",
        "synthetic_right_1.stl", "synthetic_right_3.stl"]
    v, f = synthetic_humerus(side="right",
                             rng_transform=np.random.default_rng(3))
    tri = stl.read_stl(paths[3])
    assert np.array_equal(tri, v[f].astype(np.float32))


def test_count_syncs_takes_the_second_watched_run(monkeypatch):
    """utils/bench.count_syncs counts the synchronizing-call warnings of
    the second of two watched runs (a process's first counts one more)."""
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []

    def run():
        calls.append(modes[-1])
        for _ in range(3 + (len(calls) == 1)):
            warnings.warn("called a synchronizing CUDA operation")

    assert bench.count_syncs(run) == 3
    assert calls == ["warn", "warn"] and modes == ["warn", 0, "warn", 0]


class _Event:
    def __init__(self, name, device_type=torch.autograd.DeviceType.CUDA):
        self.name, self.device_type = name, device_type


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_kernel_runs_counts_the_ports_kernels_by_name():
    """utils/bench.kernel_runs counts the device events of the port's
    kernels by the names the trace gives them (template arguments and
    namespaces included), each under its launch counter; host events,
    ranges named like a kernel and PyTorch's own kernels are left out."""
    names = [
        "void (anonymous namespace)::slice_stack_kernel<false>(float const*, "
        "int4 const*, float2 const*)",
        "void (anonymous namespace)::slice_stack_kernel<true>(float const*)",
        "(anonymous namespace)::slice_raw_kernel(float const*, int4 const*)",
        "(anonymous namespace)::sphere_score_kernel(float const*, float)",
        "void (anonymous namespace)::sphere_fit_kernel<2, 1>(float const*)",
        "void (anonymous namespace)::sphere_fit_kernel<1, 0>(float const*)",
        "(anonymous namespace)::sphere_sigma_kernel(float const*)",
        "void at::native::vectorized_elementwise_kernel<8, at::native::"
        "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)",
        "slice_stack_kernel",
    ]
    events = [_Event(n) for n in names]
    events.append(_Event("chain_walk_kernel(int const*)",
                         torch.autograd.DeviceType.CPU))
    assert bench.kernel_runs(_Profile(events)) == {
        "launches.slice_stack": 2, "launches.slice_raw": 1,
        "launches.chain_walk": 0, "launches.sphere_score": 1,
        "launches.sphere_fit": 3}
