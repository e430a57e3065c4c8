"""The port's accuracy-evidence tools against the JAX package's, on the
CPU: tools/eval_articular_torch.py, tools/eval_arthritic_ab_torch.py,
tools/eval_accuracy_torch.py and tools/refresh_evidence_torch.py.

Each tool's cohort is the JAX tool's (the draws, the redraws, the
generator's labels and truths, the BoneSpecs bit for bit), its tables
and summaries are the JAX tool's on the same rows, and its main() asks
for the card and raises without one before any ingest.  End to end, one
healthy and one arthritic bone at tiny widths (TINY's 48 x 64 label grid,
tiny_config() with the UNet run regardless, as the JAX tool runs it) go
through the port's eval_rows and are held against the JAX tool's rows
for the same bones, committed as tests/eval_articular_tiny_rows_jax.json
by `tools/eval_articular_rows_jax.py --tiny` (the JAX tool's jit alone
takes most of its 36 s here), at chip_smoke.py phase 16's gates.  The
`slow` cases make those rows afresh, and run the full 8 + 8 at
DEFAULT_CONFIG against tools/eval_articular_rows_jax.json.
"""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from shoulder_tpu.io import ingest as jax_ingest
from shoulder_tpu.io import stl as jax_stl
from shoulder_tpu.io import testdata as jax_testdata
from shoulder_tpu_torch.config import tiny_config
from test_torch_host import _build_native_ingest_once

ROOT = Path(__file__).resolve().parents[1]
SPEC_FIELDS = ("vertices", "faces", "neighbors", "face_orig",
               "obb_transform", "z_bounds", "cutoff_pcts")
N = 2


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


articular = _load("tools/eval_articular_torch.py")
ab = _load("tools/eval_arthritic_ab_torch.py")
accuracy = _load("tools/eval_accuracy_torch.py")
refresh = _load("tools/refresh_evidence_torch.py")
rows_jax = _load("tools/eval_articular_rows_jax.py")
jax_articular = _load("tools/eval_articular.py")
jax_ab = _load("tools/eval_arthritic_ab.py")
jax_accuracy = _load("tools/eval_accuracy.py")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    _build_native_ingest_once()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_specs(got, want):
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        for name in SPEC_FIELDS:
            assert np.array_equal(getattr(g, name), getattr(w, name)), name


# ------------------------------------------------------------ cohorts
@pytest.mark.parametrize("kind,seed", articular.SEEDS)
def test_articular_cohort_matches_jax_tool(kind, seed):
    """The params of both seeds, and the label grids, z_top, n_true and
    BoneSpecs the JAX tool builds from them."""
    params = articular._cohort_params(kind, N, seed)
    assert params == jax_articular._cohort_params(kind, N, seed)
    specs, grids, ztops, ntrues, nss, rads, flats = articular.cohort_inputs(
        params, kind)
    want = []
    for i, p in enumerate(params):
        v, f, label = jax_testdata.synthetic_humerus(
            return_head_label=True, n_rings=jax_articular.N_RINGS,
            n_theta=jax_articular.N_THETA, **p)
        nbr, wt = jax_stl.edge_face_adjacency(f)
        want.append(jax_ingest.spec_from_arrays(
            f"{kind}{i}", v.astype(np.float32), f.astype(np.int32), nbr,
            wt))
        n_cells = jax_articular.N_RINGS * jax_articular.N_THETA
        assert np.array_equal(grids[i], label[:n_cells].reshape(
            jax_articular.N_RINGS, jax_articular.N_THETA).astype(np.float32))
        tg = jax_testdata.truth_geometry(**p)
        assert ztops[i] == np.float32(tg["z_top"])
        assert np.array_equal(ntrues[i], tg["n_true"].astype(np.float32))
        assert (nss[i], rads[i]) == (np.float32(p["neck_shaft_deg"]),
                                     np.float32(p["head_radius"]))
        assert flats[i] == p.get("head_flattening", 0.0)
    _same_specs(specs, want)


@pytest.mark.parametrize("arthritic", [False, True])
def test_accuracy_cohort_matches_jax_tool(arthritic):
    """make_cohort: the same specs, truths and redraws, and the stream
    left where the JAX tool leaves it."""
    rng, jax_rng = np.random.default_rng(2026), np.random.default_rng(2026)
    specs, truth = accuracy.make_cohort(N, rng, arthritic)
    want, want_truth = jax_accuracy.make_cohort(N, jax_rng, arthritic)
    _same_specs(specs, want)
    assert truth == want_truth
    assert rng.bit_generator.state == jax_rng.bit_generator.state


def _fake_landmarks(n, arms=("x",)):
    """Fixed landmark rows, one set per arm, a NaN among them."""
    rng = np.random.default_rng(3)
    out = {}
    for arm in arms:
        ns = rng.uniform(100, 150, n).astype(np.float32)
        ns[-1] = np.nan
        out[arm] = SimpleNamespace(
            neckshaft=ns,
            retroversion=rng.uniform(0, 40, n).astype(np.float32),
            radius_curvature=rng.uniform(18, 28, n).astype(np.float32),
            side_is_left=rng.random(n) < 0.5,
            qc_sphere_resid=rng.uniform(0, 3, n).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def jax_ab_run():
    """tools/eval_arthritic_ab.py's main() at n = N with its batch calls
    replaced: its BoneSpecs, the rows given to its table and what it
    printed."""
    from shoulder_tpu.models import unet as jax_unet
    from shoulder_tpu.pipeline import batch as jax_batch

    fake = _fake_landmarks(N, ab.ARMS)
    seen, buf = {}, io.StringIO()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_unet, "load_default_params", lambda: {})
    mp.setattr(jax_batch, "stack_bones", lambda specs: seen.setdefault(
        "specs", specs))
    mp.setattr(jax_batch, "compute_landmarks_batch",
               lambda bones, cfg: fake[cfg.segmenter])
    mp.setattr(jax_batch, "landmarks_to_numpy", lambda lm: lm)
    mp.setattr(sys, "argv", ["eval_arthritic_ab.py", str(N)])
    try:
        with contextlib.redirect_stdout(buf):
            assert jax_ab.main() == 0
    finally:
        mp.undo()
    return seen["specs"], fake, buf.getvalue()


def test_ab_cohort_matches_jax_tool(jax_ab_run):
    """The A/B cohort: the same draws (a redraw would skip a name),
    BoneSpecs bit for bit, and the rows tool's copy of the draw too."""
    specs, truth, draws = ab.make_cohort(N)
    _same_specs(specs, jax_ab_run[0])
    assert [s.name for s in specs] == [f"arth{d}" for d in draws]
    jax_specs, jax_truth, jax_draws = rows_jax.ab_cohort(N)
    _same_specs(specs, jax_specs)
    assert (truth, draws) == (jax_truth, jax_draws)


# ------------------------------------------------------ tables, summaries
def test_ab_table_matches_jax_tool(jax_ab_run):
    specs, fake, printed = jax_ab_run
    _, truth, draws = ab.make_cohort(N)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = ab.table(truth, draws, fake)
    assert buf.getvalue() == printed
    assert [r["unet_resid"] for r in rows] == [
        float(x) for x in fake["unet"].qc_sphere_resid]


def test_accuracy_table_matches_jax_tool():
    rng = np.random.default_rng(5)
    truth = [dict(neck_shaft_deg=float(rng.uniform(125, 145)),
                  retroversion_deg=float(rng.uniform(15, 40)),
                  head_radius=float(rng.uniform(20, 27)),
                  side=side) for side in ("left", "right", "left")]
    lm = _fake_landmarks(3)["x"]
    printed = []
    for table in (accuracy.table, jax_accuracy.table):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = table("arthritic", lm, truth)
        printed.append((buf.getvalue(), json.dumps(result)))
    assert printed[0] == printed[1]


def test_articular_summarize_matches_jax_tool():
    rng = np.random.default_rng(9)
    results = {kind: {"rows": rng.uniform(0, 40, (5, 10)).astype(np.float32),
                      "flattening": rng.uniform(0.12, 0.3, 5)}
               for kind in ("healthy", "arthritic")}
    results["arthritic"]["rows"][1, 4] = np.nan
    assert articular.COLS == jax_articular.COLS
    assert (articular.summarize(results)
            == jax_articular.summarize(results))


def test_refresh_table_and_readme_block(tmp_path, monkeypatch):
    """The README block from the four tools' outputs: written at the end
    of the port's section, then replaced in place, the card named."""
    monkeypatch.setattr(refresh, "TOOLS", tmp_path)
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    s = dict(mean=0.5, abs_mean=1.0, abs_max=2.0, nan=0)
    summary = dict(ns_err=s, rv_err=s, r_err=s, side_acc=1.0)
    acc = {c: {"summary": summary} for c in ("healthy", "arthritic")}
    for name in ("eval_accuracy_torch_results.json",
                 "eval_accuracy_torch_sphere.json"):
        (tmp_path / name).write_text(json.dumps({**acc, "card": card}))
    art = {"healthy": {"n": 1, **{c: 1.0 for c in articular.COLS}}}
    (tmp_path / "eval_articular_torch_results.json").write_text(
        json.dumps({**art, "rows": {}, "card": card}))
    (tmp_path / "eval_arthritic_ab_torch_results.json").write_text(
        json.dumps({"rows": [dict(truth_ns=130.0, sphere_ns=120.0,
                                  unet_ns=131.0)], "card": card}))
    table = refresh.accuracy_table_md(8)
    assert table.startswith(refresh.BEGIN) and table.endswith(refresh.END)
    assert card in table and "| healthy | 1 | 1.000 |" in table
    assert "sphere 10.00 / 10.00 deg, unet 1.00 / 1.00 deg" in table
    readme = tmp_path / "README.md"
    readme.write_text(f"# x\n\n{refresh.SECTION}\n\ntext\n\n## Next\n")
    monkeypatch.setattr(refresh, "README", readme)
    refresh.rewrite_readme(table)
    first = readme.read_text()
    assert first.index(refresh.BEGIN) < first.index("## Next")
    refresh.rewrite_readme(table.replace("8/cohort", "4/cohort"))
    assert readme.read_text() == first.replace("8/cohort", "4/cohort")


# ---------------------------------------------------------- end to end
def _tiny(monkeypatch):
    tiny = rows_jax.TINY
    for key in ("N_RINGS", "N_THETA", "BATCH"):
        monkeypatch.setattr(articular, key, tiny[key])
    return tiny["n"]


def _assert_rows_within_gates(got, ref):
    """chip_smoke.py phase 16's gates, bone by bone."""
    for kind, (ga, gn, gr) in (("healthy", (chip_smoke.ACC_GATE,) * 3),
                               ("arthritic", chip_smoke.ACC_ARTHRITIC_GATE)):
        assert np.array_equal(got[kind]["flattening"],
                              ref[kind]["flattening"])
        want = np.asarray(ref[kind]["rows"], np.float64)
        diff = np.abs(got[kind]["rows"].astype(np.float64) - want)
        limits = np.array([chip_smoke.EVIDENCE_IOU] * 3 + [ga] * 2
                          + [gn] * 2 + [gr] * 2 + [0.0])
        assert (diff <= limits).all(), (kind, np.round(diff, 4))


@pytest.fixture(scope="module")
def tiny_rows():
    mp = pytest.MonkeyPatch()
    try:
        return articular.run_cohorts(_tiny(mp), "cpu", tiny_config())
    finally:
        mp.undo()


def test_tiny_rows_match_jax_rows(tiny_rows):
    ref = json.loads((ROOT / "tests" / "eval_articular_tiny_rows_jax.json")
                     .read_text())
    assert ref["tiny"] == rows_jax.TINY
    _assert_rows_within_gates(tiny_rows, ref["articular"])


@pytest.mark.slow
def test_tiny_rows_match_fresh_jax_rows(tiny_rows):
    """The committed tiny rows are still the JAX tool's, and the port
    holds against them made afresh."""
    _, fresh = rows_jax.articular_rows(rows_jax.TINY["n"], tiny=True)
    ref = json.loads((ROOT / "tests" / "eval_articular_tiny_rows_jax.json")
                     .read_text())["articular"]
    for kind in fresh:
        assert np.allclose(fresh[kind]["rows"], ref[kind]["rows"],
                           rtol=0, atol=1e-4), kind
    _assert_rows_within_gates(tiny_rows, {
        kind: {key: v.tolist() for key, v in d.items()}
        for kind, d in fresh.items()})


@pytest.mark.slow
def test_full_rows_match_jax_rows():
    """The full 8 + 8 at DEFAULT_CONFIG on the CPU against the committed
    JAX rows, at phase 16's gates."""
    ref = json.loads((ROOT / "tools" / "eval_articular_rows_jax.json")
                     .read_text())["articular"]
    got = articular.run_cohorts(len(ref["healthy"]["rows"]), "cpu")
    _assert_rows_within_gates(got, ref)


# --------------------------------------------------------- no fallback
@pytest.mark.parametrize("tool,entry", [
    (articular, "run_cohorts"), (ab, "make_cohort"),
    (accuracy, "make_cohort"), (refresh, "run")])
def test_main_raises_without_cuda(monkeypatch, tool, entry):
    """main() asks for the card and raises without one, before any
    ingest: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_fallback(*args, **kwargs):
        raise AssertionError("fell back to the CPU")

    monkeypatch.setattr(tool, entry, no_fallback)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
