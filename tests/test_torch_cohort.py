"""The port's process_cohort vs shoulder_tpu's, on the CPU at tiny_config.

Three synthetic bones in batches of 2: one full batch and one padded
short batch, with the second batch's ingest prefetched on the worker.
"""

import numpy as np
import pytest

from shoulder_tpu import cohort as j_cohort
from shoulder_tpu.config import tiny_config as jax_tiny_config
from shoulder_tpu_torch import cohort as t_cohort
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.io import stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus

METRICS = ("retroversion_deg", "neckshaft_deg", "radius_curvature_mm")


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
