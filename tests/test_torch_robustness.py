"""The arthritic cohort and the NaN trap through the port on the CPU.

tests/test_arthritic_cohort.py's cohort (`default_rng(7)`, a healthy
bone and three arthritic variants, written as STLs and loaded by the
port's `load_bone`, tiny_config; chip_smoke's `robust_cohort`, which
phase 14d runs on the card) must pass that test's four checks as
written.  Bone 0 alone equals bone 0 of the batch bit for bit: the
port's form of that test's failure isolation.

tests/test_sanitizers.py runs the JAX pipeline under `jax_debug_nans`;
its twin here runs the batch, and bone 0 alone (the sanitizer's input),
under `utils.nan_trap`, which checks every floating-point output of
every aten call (and of every kernel launch, on the card) for a NaN and
raises at the first.  The trap must find no site, and must leave bone
0's landmarks bit for bit as they are without it (phase 14d checks the
same on the card for the cohort and phase 4's batch).  The cohort's
four checks read the trapped batch: each run of the cohort costs
seconds, so it runs once.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.models import forest
from shoulder_tpu_torch.ops import slicing
from shoulder_tpu_torch.pipeline import batch as tbatch
from shoulder_tpu_torch.pipeline import landmarks as tlm
from shoulder_tpu_torch.utils import geometry, nan_trap

CFG = tiny_config()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    return chip_smoke.robust_cohort(str(tmp_path_factory.mktemp("robust")),
                                    CFG)


@pytest.fixture(scope="module")
def rf():
    return forest.load_params("cpu")


def _run(specs, rf):
    return tbatch.compute_landmarks_batch(tbatch.stack_bones(specs, "cpu"),
                                          rf, cfg=CFG, chunk=16)


@pytest.fixture(scope="module")
def trapped(specs, rf):
    """The batch and bone 0 alone, each under the NaN trap:
    {"batch" / "bone 0": (landmarks, trap)}."""
    out = {}
    for name, n in (("batch", len(specs)), ("bone 0", 1)):
        with nan_trap.trap() as mode:
            out[name] = (_run(specs[:n], rf), mode)
    return out


@pytest.fixture(scope="module")
def cohort(trapped):
    return tbatch.landmarks_to_numpy(trapped["batch"][0])


def test_all_bones_finite(cohort):
    lm = cohort
    assert np.isfinite(lm.neckshaft).all()
    assert np.isfinite(lm.retroversion).all()
    assert np.isfinite(lm.radius_curvature).all()
    assert np.isfinite(lm.canal_axis).all()
    assert np.isfinite(lm.te_axis).all()


def test_qc_responds_to_degeneracy(cohort):
    lm = cohort
    healthy_resid = lm.qc_sphere_resid[0]
    worst_resid = lm.qc_sphere_resid[3]
    # the flattened+osteophytic head must fit a sphere worse than healthy
    assert worst_resid > healthy_resid


def test_failure_isolation(cohort):
    lm = cohort
    assert 60.0 < lm.neckshaft[0] < 180.0
    assert lm.radius_curvature[0] > 5.0


def test_no_slice_overflow(cohort):
    assert not cohort.qc_slice_overflow.any()


def test_cohort_gate_of_the_card_agrees(cohort):
    """chip_smoke's gate (phase 14d) holds what the four checks hold."""
    assert chip_smoke.robust_failures(cohort) == []


@pytest.fixture(scope="module")
def bone0(specs, rf):
    """Bone 0 alone, without the trap."""
    return tlm.compute_landmarks(tbatch.bone_tensors(specs[0], "cpu"), rf,
                                 cfg=CFG, chunk=16)


def test_bone0_alone_equals_its_batch_row(trapped, bone0):
    batch = trapped["batch"][0]
    for name, got, want in zip(tlm.Landmarks._fields, bone0, batch):
        assert got.dtype == want.dtype and torch.equal(got, want[0]), name


@pytest.mark.parametrize("bones", ["batch", "bone 0"])
def test_pipeline_clean_under_nan_trap(trapped, bones):
    """No NaN site and finite landmarks, over the cohort and over bone 0
    alone (the sanitizer's input)."""
    lm, mode = trapped[bones]
    assert mode.sites == [] and mode.calls > 1000
    assert torch.isfinite(lm.neckshaft).all()
    assert torch.isfinite(lm.canal_axis).all()
    assert torch.isfinite(lm.radius_curvature).all()


def test_nan_trap_leaves_the_landmarks_bit_for_bit(trapped, bone0):
    lm = trapped["bone 0"][0]
    for name, got, want in zip(tlm.Landmarks._fields, lm, bone0):
        assert torch.equal(got[0], want), name


def test_nan_trap_names_the_op_and_the_port_frame():
    zero = torch.zeros(1, 3)
    with pytest.raises(nan_trap.NanError,
                       match=r"aten\.\w+.* at shoulder_tpu_torch/utils/"
                             r"geometry\.py:\d+ in unit_vector"):
        with nan_trap.trap():
            geometry.unit_vector(zero, zero)
    with nan_trap.trap(raise_first=False) as mode:
        torch.zeros(2) / torch.zeros(2)
        torch.ones(2) / torch.zeros(2)      # inf, not NaN
    assert [s.op for s in mode.sites] == ["aten.div.Tensor"]
    assert mode.sites[0].frame == "outside shoulder_tpu_torch"


def test_nan_trap_poisons_uninitialized_memory():
    """The outputs of empty* are filled with NaN, not checked: reading a
    slot nothing wrote is a site, writing before reading is none."""
    with nan_trap.trap(raise_first=False) as mode:
        x = torch.empty(4)
        assert torch.isnan(x).all()
        x.copy_(torch.arange(4.0))
        y = torch.empty(4) + x
    assert [s.op for s in mode.sites] == ["aten.add.Tensor"]
    assert not torch.isnan(x).any() and torch.isnan(y).all()


def test_nan_trap_checks_kernel_launches(monkeypatch):
    """The kernels bypass the dispatcher: the trap checks what the
    wrappers return, and puts the wrappers back after the block."""
    out = slicing.SliceStack(*[torch.zeros(2)] * 6,
                             torch.tensor([float("nan")]))

    def fake_kernel(*args, **kwargs):
        return out

    monkeypatch.setattr(slicing, "slice_stack_kernel", fake_kernel)
    with pytest.raises(nan_trap.NanError, match="slicing.slice_stack_kernel"):
        with nan_trap.trap():
            slicing.slice_stack_kernel()
    assert slicing.slice_stack_kernel is fake_kernel
