"""The port's process_cohort vs shoulder_tpu's, on the CPU at tiny_config.

Three synthetic bones in batches of 2: one full batch and one padded
short batch, with the second batch's ingest prefetched.  Then the
prefetch's pool of ingest threads against the serial prefetch (the pool
size patched to 1): the same rows bit for bit, the same BoneSpecs, an
ingest error raised with no thread left, the counters, and the rule that
sizes the pool.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

from shoulder_tpu import cohort as j_cohort
from shoulder_tpu.config import tiny_config as jax_tiny_config
from shoulder_tpu_torch import cohort as t_cohort
from shoulder_tpu_torch import config as config_mod
from shoulder_tpu_torch.config import SliceSetConfig, tiny_config
from shoulder_tpu_torch.io import ingest, native, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.pipeline import batch as B
from shoulder_tpu_torch.utils import trace

METRICS = ("retroversion_deg", "neckshaft_deg", "radius_curvature_mm")
TINY = tiny_config()
# tests/test_torch_dense.py's second padding: a 96 x 64 mesh (12,288
# faces) is past TINY as a ~250k-face mesh is past DEFAULT_CONFIG
TINY_DENSE = dataclasses.replace(
    tiny_config(max_faces=32768, max_verts=16384), max_chain=1024,
    slice_compact_k=1024,
    **{name: SliceSetConfig(zslice_num=s, interp_num=n, band=2048)
       for name, (s, n) in (("full", (64, 64)), ("proximal", (96, 128)),
                            ("distal", (48, 96)))})
POOL_THREADS = ("cohort-ingest", "cohort-prefetch")


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    d = tmp_path_factory.mktemp("cohort")
    paths = []
    for i, side in enumerate(("left", "right", "left")):
        v, f = synthetic_humerus(side=side, n_rings=60, n_theta=48,
                                 rng_transform=np.random.default_rng(10 + i))
        paths.append(d / f"bone{i}.stl")
        stl.write_stl(paths[-1], v, f)
    ref = j_cohort.process_cohort(paths, config=jax_tiny_config(),
                                  batch_size=2)
    got = t_cohort.process_cohort(paths, config=tiny_config(), device="cpu",
                                  batch_size=2)
    return ref, got


def test_process_cohort_matches_jax(cohorts):
    """Bone for bone, the padded short batch included: side and QC flags
    equal, metrics within 0.75 (bench gate), CT-frame axes within
    1e-2 mm."""
    ref, got = cohorts
    assert len(got) == len(ref) == 3
    for r, g in zip(ref, got):
        assert g["name"] == r["name"]
        assert g["side"] == r["side"]
        for m in METRICS:
            assert abs(g[m] - r[m]) < 0.75, m
        assert g["neck_z"] == pytest.approx(r["neck_z"], abs=1e-3)
        for k in ("canal_axis_ct", "te_axis_ct", "bg_axis_ct"):
            assert g[k].shape == (2, 3)
            assert np.allclose(g[k], r[k], atol=1e-2), k
        for k in ("slice_band_overflow", "peak_capacity_overflow",
                  "open_edges"):
            assert g["qc"][k] == r["qc"][k], k
        assert g["qc"].keys() == r["qc"].keys()


def test_cohort_summary_matches_jax(cohorts):
    ref, got = cohorts
    sj, st = j_cohort.cohort_summary(ref), t_cohort.cohort_summary(got)
    assert st.keys() == sj.keys()
    for k in sj:
        assert st[k] == pytest.approx(sj[k], abs=0.75), k
    assert st["n"] == 3 and st["qc_flags"] == sj["qc_flags"]
    assert st["left_fraction"] == sj["left_fraction"]


def test_empty_cohort():
    assert t_cohort.process_cohort([], device="cpu") == []
    assert t_cohort.process_cohort([]) == j_cohort.process_cohort([]) == []


# ------------------------------------------------- the pool of ingest threads
def _write_bones(d, grids):
    paths = []
    for i, (rings, sectors) in enumerate(grids):
        v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                 n_rings=rings, n_theta=sectors,
                                 rng_transform=np.random.default_rng(50 + i))
        paths.append(d / f"pool{i}.stl")
        stl.write_stl(paths[-1], v, f)
    return paths


def _same_rows(got, want):
    """Two process_cohort results equal bit for bit, row by row."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], dict):
                _same_rows([g[k]], [w[k]])
            else:
                a, b = np.asarray(g[k]), np.asarray(w[k])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _same_spec(got, want):
    """Two BoneSpecs equal field by field, arrays bit for bit."""
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, field.name
            assert g.tobytes() == w.tobytes(), field.name
        else:
            assert g == w, field.name


def _pool_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(POOL_THREADS)]


def _passes(monkeypatch, paths, **kw):
    """process_cohort's serial pass (a pool of 1), then its pooled pass:
    ((rows, counters, specs by chunk), ...).  Specs are those handed to
    stack_host, keyed by their bones' names."""
    stacked = {}
    stack_host = B.stack_host

    def recording(specs, pin=False):
        stacked[tuple(s.name for s in specs)] = list(specs)
        return stack_host(specs, pin=pin)

    monkeypatch.setattr(B, "stack_host", recording)
    out = []
    for size in (lambda n: 1, t_cohort._pool_size):
        monkeypatch.setattr(t_cohort, "_pool_size", size)
        stacked.clear()
        trace.reset()
        rows = t_cohort.process_cohort(paths, device="cpu", **kw)
        out.append((rows, trace.counters(), dict(stacked)))
    trace.reset()
    return out


@pytest.fixture(scope="module")
def pool_paths(tmp_path_factory):
    """Five sparse bones, then a sparse and a dense one (TINY_DENSE's)."""
    d = tmp_path_factory.mktemp("pool")
    return _write_bones(d, [(40, 32)] * 5 + [(60, 48), (96, 64)])


@pytest.fixture(scope="module")
def pool_passes(pool_paths):
    """Five bones in batches of 2 (a short last chunk) at TINY."""
    with pytest.MonkeyPatch.context() as mp:
        return _passes(mp, pool_paths[:5], config=TINY, batch_size=2)


def test_pooled_pass_gives_the_serial_rows(pool_paths, pool_passes):
    """A short last chunk: the pooled pass's rows are the serial pass's,
    bit for bit, in the order of the paths; neither leaves a thread."""
    (serial, _, _), (pooled, _, _) = pool_passes
    assert [r["name"] for r in pooled] == [p.stem for p in pool_paths[:5]]
    _same_rows(pooled, serial)
    assert _pool_threads() == []


def test_pooled_pass_counts_each_bone_once(pool_passes):
    """cohort.bones_ingested is the number of bones; cohort.ingest_overlap
    lies between 0 and it, and is 0 with a pool of 1."""
    (_, serial, _), (_, pooled, _) = pool_passes
    for counts in (serial, pooled):
        assert counts["cohort.bones_ingested"] == 5
        assert 0 <= counts["cohort.ingest_overlap"] <= 5
        assert counts["cohort.wait_ns"] > 0
    assert serial["cohort.ingest_overlap"] == 0


def test_pooled_pass_pads_by_size_as_the_serial_one(monkeypatch, pool_paths):
    """config=None over a chunk of a sparse and a dense bone (two
    paddings, two batches), behind a full chunk: the rows bit for bit, and
    the BoneSpecs handed to stack_host field by field."""
    monkeypatch.setattr(config_mod, "PADDINGS", (TINY, TINY_DENSE))
    paths = pool_paths[3:7]
    (serial, _, s_specs), (pooled, _, p_specs) = _passes(
        monkeypatch, paths, batch_size=2)
    assert [r["name"] for r in pooled] == [p.stem for p in paths]
    _same_rows(pooled, serial)
    assert p_specs.keys() == s_specs.keys()
    assert {s.config.max_faces for specs in p_specs.values()
            for s in specs} == {TINY.max_faces, TINY_DENSE.max_faces}
    for key, specs in s_specs.items():
        assert len(p_specs[key]) == len(specs)
        for got, want in zip(p_specs[key], specs):
            _same_spec(got, want)


def test_failing_ingest_raises_and_leaves_no_thread(monkeypatch, tmp_path,
                                                     pool_paths):
    """A truncated STL among the paths: its error reaches the caller, the
    chunks past the two ingested ahead never start, and no pool or
    prefetch thread is left."""
    bad = tmp_path / "bad.stl"
    bad.write_bytes(bytes(80) + (1000).to_bytes(4, "little") + bytes(50))
    paths = [pool_paths[0], bad] + [pool_paths[i % 5] for i in range(12)]
    started = []
    load_bone = ingest.load_bone

    def counted(path, **kw):
        started.append(path)
        return load_bone(path, **kw)

    monkeypatch.setattr(ingest, "load_bone", counted)
    with pytest.raises(ValueError, match="truncated"):
        t_cohort.process_cohort(paths, config=TINY, batch_size=1,
                                device="cpu")
    assert len(started) <= 1 + t_cohort.AHEAD
    assert _pool_threads() == []


@pytest.mark.parametrize("cpus", [1, 2, 8])
@pytest.mark.parametrize("bones", [1, 8, 64])
def test_pool_size_follows_the_usable_cpus(monkeypatch, cpus, bones):
    """One CPU or one bone gives 1; otherwise the pool is at most the
    bones, the usable CPUs less one and POOL_CAP, and takes all three."""
    monkeypatch.setattr(t_cohort.os, "sched_getaffinity",
                        lambda pid: set(range(cpus)))
    size = t_cohort._pool_size(bones)
    if cpus == 1 or bones == 1:
        assert size == 1
    else:
        assert 1 <= size <= min(bones, cpus - 1, t_cohort.POOL_CAP)
        assert size == min(bones, cpus - 1, t_cohort.POOL_CAP)


def test_ingest_shares_no_state_across_threads(monkeypatch):
    """32 threads on few cores with a short switch interval: every bone
    counted once as running and once done (none left running), each
    overlap among them, and the native library loaded once for all."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(ingest, "load_bone",
                        lambda path, **kw: native.library())
    monkeypatch.setattr(native, "_lib", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        trace.reset(["cohort.ingest_overlap"])
        with ThreadPoolExecutor(32) as pool:
            bones = t_cohort._Ingest(pool, False, TINY)
            futures = [bones.submit(i, None, None) for i in range(400)]
            libs = {id(f.result(timeout=60)) for f in futures}
    finally:
        sys.setswitchinterval(interval)
    assert bones.running == 0
    assert len(libs) == 1
    assert 0 < trace.counter("cohort.ingest_overlap") < 400
    trace.reset(["cohort.ingest_overlap"])
