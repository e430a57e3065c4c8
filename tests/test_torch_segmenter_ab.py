"""The sphere segmenter of the port at DEFAULT_CONFIG on the CPU, against
the JAX package's rows, and tests/test_segmenter_ab.py's A/B tripwire.

The default ("unet") articular path seeds the robust-sphere consensus
with the CNN's mask; its fallback is the plain sphere consensus
(`segmenter="sphere"`), whose JAX results for phase 11's cohorts
(`default_rng(2026)`, chip_smoke's `accuracy_cohort`) are committed in
tools/eval_accuracy_sphere.json.  Tier-1 runs arthritic bone 1, the
cohort's largest sphere-arm gap on the CPU (0.0023 / 0.2264 / 0.0004),
against its row at chip_smoke's ACC_ARTHRITIC_GATE (0.3 deg / 0.3 deg /
0.05 mm); a few seconds on one thread.

The `slow` cases run all 16 bones of those cohorts under the sphere arm
(healthy within bench.py's 0.75, arthritic within ACC_ARTHRITIC_GATE of
their rows), and the tripwire: on `default_rng(77)`'s cohorts of 4, the
UNet arm may lose to the sphere arm by no more than MARGIN on |max|
error against the truth.  Phase 14b runs the same on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from shoulder_tpu_torch.config import DEFAULT_CONFIG
from shoulder_tpu_torch.models import forest, unet
from shoulder_tpu_torch.pipeline import batch as tbatch
from shoulder_tpu_torch.pipeline import landmarks as tlm

SPHERE = dataclasses.replace(DEFAULT_CONFIG, segmenter="sphere")
GATES = {"healthy": (chip_smoke.ACC_GATE,) * 3,
         "arthritic": chip_smoke.ACC_ARTHRITIC_GATE}
BONE = 1
METRICS = ("ns", "rv", "rad")
# DEFAULT_CONFIG on the CPU holds a few GB per bone batch: 4 at a time
CHUNK = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohorts():
    rng = np.random.default_rng(2026)
    return {name: chip_smoke.accuracy_cohort(rng, name == "arthritic")
            for name in ("healthy", "arthritic")}


def _metrics(lm):
    return np.stack([lm.neckshaft, lm.retroversion, lm.radius_curvature],
                    -1).astype(np.float64)


def _rows(name):
    rows = chip_smoke.tool_json("eval_accuracy_sphere.json")[name]["rows"]
    return rows, np.array([[r["ns"], r["rv"], r["r"]] for r in rows])


def _batches(specs, cfg, seg_model=None):
    """Landmarks (numpy) of specs, CHUNK bones per batch."""
    parts = [tbatch.landmarks_to_numpy(tbatch.compute_landmarks_batch(
        tbatch.stack_bones(specs[i:i + CHUNK], "cpu"),
        forest.load_params("cpu"), cfg=cfg, seg_model=seg_model))
        for i in range(0, len(specs), CHUNK)]
    return tlm.Landmarks(*(np.concatenate(x) for x in zip(*parts)))


def test_arthritic_bone1_sphere_matches_jax_row(cohorts):
    specs, truth = cohorts["arthritic"]
    rows, ref = _rows("arthritic")
    assert rows[BONE]["ns_truth"] == truth[BONE]["neck_shaft_deg"]
    lm = tlm.compute_landmarks(tbatch.bone_tensors(specs[BONE], "cpu"),
                               forest.load_params("cpu"), cfg=SPHERE)
    assert rows[BONE]["side_ok"]
    assert bool(lm.side_is_left) == (truth[BONE]["side"] == "left")
    got = np.array([float(lm.neckshaft), float(lm.retroversion),
                    float(lm.radius_curvature)])
    assert (np.abs(got - ref[BONE]) <= chip_smoke.ACC_ARTHRITIC_GATE).all(), \
        (got, ref[BONE])


@pytest.mark.slow
@pytest.mark.parametrize("name", ["healthy", "arthritic"])
def test_cohort_sphere_matches_jax_rows(cohorts, name):
    specs, truth = cohorts[name]
    rows, ref = _rows(name)
    assert [r["ns_truth"] for r in rows] == [t["neck_shaft_deg"]
                                             for t in truth]
    lm = _batches(specs, SPHERE)
    # the JAX package's sphere arm calls some arthritic sides wrong
    side_ok = [bool(x) == (t["side"] == "left")
               for x, t in zip(lm.side_is_left, truth)]
    assert side_ok == [r["side_ok"] for r in rows]
    diff = np.abs(_metrics(lm) - ref)
    assert (diff < GATES[name]).all(), np.round(diff, 4)


@pytest.fixture(scope="module")
def ab_results():
    """Each arm's |error| against the truth on default_rng(77)'s cohorts,
    {kind: {arm: {metric: (4,)}}}."""
    rng = np.random.default_rng(77)
    out = {}
    for kind in ("healthy", "arthritic"):
        specs, truth = chip_smoke.accuracy_cohort(
            rng, kind == "arthritic", chip_smoke.AB_PER_COHORT)
        want = np.array([[t["neck_shaft_deg"], t["retroversion_deg"],
                          t["head_radius"]] for t in truth])
        out[kind] = {}
        for seg in ("unet", "sphere"):
            cfg = dataclasses.replace(DEFAULT_CONFIG, segmenter=seg)
            model = unet.load_model("cpu") if seg == "unet" else None
            err = np.abs(_metrics(_batches(specs, cfg, model)) - want)
            out[kind][seg] = dict(zip(METRICS, err.T))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["healthy", "arthritic"])
@pytest.mark.parametrize("metric", METRICS)
def test_default_never_worse_than_sphere(ab_results, kind, metric):
    unet_err = ab_results[kind]["unet"][metric]
    sphere_err = ab_results[kind]["sphere"][metric]
    assert np.isfinite(unet_err).all(), f"{kind}/{metric}: non-finite default"
    worse = np.max(unet_err) - np.max(sphere_err)
    assert worse < chip_smoke.AB_MARGIN[metric], (
        f"{kind}: default |max| {metric} err {np.max(unet_err):.2f} vs "
        f"sphere {np.max(sphere_err):.2f} — default is worse by "
        f"{worse:.2f} (margin {chip_smoke.AB_MARGIN[metric]}); per-bone "
        f"default {np.round(unet_err, 2)} sphere {np.round(sphere_err, 2)}")
