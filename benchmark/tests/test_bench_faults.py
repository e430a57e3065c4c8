"""The comparison catches a broken timed path: each fault the cells can
have, planted under a tiny run on the CPU, makes `correct` false."""

import numpy as np
import pytest

from benchmark.harness import programs as P
from benchmark.tests import tiny


def _altered(lm):
    """An answer altered where it is produced: bone 0's retroversion."""
    retro = np.array(lm.retroversion, copy=True)
    retro[0] += 5.0
    return lm._replace(retroversion=retro)


def _one_slot(field, shift):
    """One slot of every batch wrong where it is produced: slot 0's
    `field` moved by `shift` (mm).  At the tiny size a slot is half the
    bones; at batch 8 a canal so moved fails `widest_mm`, and a groove
    (4 of 32 bones) reads a `groove_share` of 0.125-0.19, under its
    limit (PERF.md)."""
    def alter(lm):
        x = np.array(getattr(lm, field), copy=True)
        x[0] += shift
        return lm._replace(**{field: x})
    return alter


def _half(batch_fn):
    """Half of the batch left out: the first half's bones computed, and
    their answers given for the rest."""
    def fn(bones, *args, **kwargs):
        n = bones.verts.shape[0]
        half = type(bones)(*(x[: max(n // 2, 1)] for x in bones))
        lm = batch_fn(half, *args, **kwargs)
        reps = -(-n // half.verts.shape[0])
        return type(lm)(*(x.repeat((reps,) + (1,) * (x.dim() - 1))[:n]
                          for x in lm))
    return fn


def _stale(batch_fn):
    """A step that hands back the state of the step before: the previous
    call's answers."""
    last = {}

    def fn(bones, *args, **kwargs):
        out = last.get("lm")
        last["lm"] = batch_fn(bones, *args, **kwargs)
        return out if out is not None else last["lm"]
    return fn


ALTER = {"altered": _altered,
         "canal_slot": _one_slot("canal_axis", 1.0),
         "groove_slot": _one_slot("bg_points", 5.0)}


@pytest.mark.parametrize("fault", [*ALTER, "half", "stale"])
def test_batch_faults(monkeypatch, fault):
    if fault in ALTER:
        to_np = P.B.landmarks_to_numpy
        monkeypatch.setattr(P.B, "landmarks_to_numpy",
                            lambda lm: ALTER[fault](to_np(lm)))
    else:
        wrap = _half if fault == "half" else _stale
        monkeypatch.setattr(P.B, "compute_landmarks_batch",
                            wrap(P.B.compute_landmarks_batch))
    result, correct = tiny.run("mesh_unet.batch8")
    assert not correct and not result["correct"]


def test_ct_mesh_fault(monkeypatch):
    """The welded mesh altered: one vertex moved by 0.5 mm."""
    to_spec = P.ct.volume_to_spec

    def moved(*args, **kwargs):
        spec = to_spec(*args, **kwargs)
        spec.vertices_raw = spec.vertices_raw.copy()
        spec.vertices_raw[0, 0] += 0.5
        return spec
    monkeypatch.setattr(P.ct, "volume_to_spec", moved)
    result, correct = tiny.run("ct_unet.batch4")
    assert not correct


def test_cohort_fault(monkeypatch):
    process = P.cohort.process_cohort

    def altered(*args, **kwargs):
        out = process(*args, **kwargs)
        out[0] = dict(out[0], neckshaft_deg=out[0]["neckshaft_deg"] + 5.0)
        return out
    monkeypatch.setattr(P.cohort, "process_cohort", altered)
    result, correct = tiny.run("mesh_unet.cohort64")
    assert not correct


def test_facade_fault(monkeypatch):
    cls = P.bone.Humerus
    orig = cls.radius_curvature
    monkeypatch.setattr(cls, "radius_curvature",
                        lambda self: orig(self) + 0.5)
    result, correct = tiny.run("mesh_unet.single")
    assert not correct
