"""Arthritic bone 5 of the accuracy cohort through the port on the CPU,
against the JAX package's committed row, and the one-rounding bf16
convolution that brought the card's arthritic cohort back to its rows.

The cohort is tests/test_accuracy_gate.py's (healthy first, then
arthritic, one `default_rng(2026)` stream), made by chip_smoke.py's
`accuracy_cohort`, which phase 11 runs on the card.  Bone 5 is the
cohort's outlier: the support gate takes its rescue branch, where a few
hundred mask pixels move the neck-shaft angle and retroversion by
degrees.  On the CPU the port gives the JAX row within 0.12 deg / 0.04
deg / 0.02 mm; this test holds it to 0.3 deg / 0.3 deg / 0.05 mm at
DEFAULT_CONFIG with the shipped UNet (the whole cohort takes about a
minute on one thread, bone 5 alone a few seconds).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from shoulder_tpu_torch.config import DEFAULT_CONFIG
from shoulder_tpu_torch.models import ct_unet, forest, unet
from shoulder_tpu_torch.pipeline import batch as tbatch
from shoulder_tpu_torch.pipeline import landmarks as tlm

ROWS = Path(__file__).resolve().parents[1] / "tools" / \
    "eval_accuracy_results.json"
BONE = 5
TOL = (0.3, 0.3, 0.05)   # neck-shaft deg, retroversion deg, radius mm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_arthritic_bone5_matches_jax_row():
    rng = np.random.default_rng(2026)
    chip_smoke.accuracy_cohort(rng, arthritic=False)
    specs, truth = chip_smoke.accuracy_cohort(rng, arthritic=True)
    with open(ROWS) as fh:
        row = json.load(fh)["arthritic"]["rows"][BONE]
    assert row["ns_truth"] == truth[BONE]["neck_shaft_deg"]

    lm = tlm.compute_landmarks(
        tbatch.bone_tensors(specs[BONE], "cpu"), forest.load_params("cpu"),
        cfg=DEFAULT_CONFIG, seg_model=unet.load_model("cpu"))
    got = (float(lm.neckshaft), float(lm.retroversion),
           float(lm.radius_curvature))
    want = (row["ns"], row["rv"], row["r"])
    assert bool(lm.side_is_left) == (truth[BONE]["side"] == "left")
    for name, g, w, tol in zip(("neck-shaft", "retroversion", "radius"),
                               got, want, TOL):
        assert abs(g - w) <= tol, (name, g, w)


def _conv_case(dims):
    """A bf16 CastConv of `dims` spatial dims and an input for it."""
    torch.manual_seed(dims)
    if dims == 2:
        conv = unet.CastConv2d(8, 16, 3, padding=(1, 0))
        x = torch.randn(2, 8, 24, 26, requires_grad=True)
    else:
        conv = ct_unet.CastConv3d(4, 8, 3, padding=1)
        x = torch.randn(1, 4, 10, 12, 12, requires_grad=True)
    with torch.no_grad():
        conv.bias.normal_(0.0, 1.0)
    return conv, x


@pytest.mark.parametrize("dims", [2, 3])
def test_round_once_conv_is_the_cpu_bf16_conv(dims):
    """`_RoundOnce`, which the card's bf16 convolutions take, gives on the
    CPU what oneDNN's bf16 convolution gives, bit for bit, forward and
    backward: the sum and its bias rounded to bf16 once, at the bf16
    rounding floor of a float64 reference on the same operands.  Rounding
    the sum before adding the bias (cuDNN's sum, then a separate bias add)
    gives another value for a few percent of the outputs."""
    conv, x = _conv_case(dims)
    bf = torch.bfloat16
    xb, wb, bb = x.to(bf), conv.weight.to(bf), conv.bias.to(bf)
    once = unet._RoundOnce.apply(conv, xb, wb, bb)
    plain = conv._conv_forward(xb, wb, bb)
    assert once.dtype == bf and torch.equal(once, plain)

    ref = conv._conv_forward(xb.double(), wb.double(), bb.double()).detach()

    def err(y):
        return float((y.detach().double() - ref).norm() / ref.norm())

    floor = err(ref.to(bf))
    assert err(once) <= 1.01 * floor
    twice = conv._conv_forward(xb, wb, None) + bb.reshape(
        (-1,) + (1,) * dims)
    assert float((twice != once).double().mean()) > 0.01

    g = torch.randn(once.shape, generator=torch.Generator().manual_seed(1)
                    ).to(bf)
    params = [x, conv.weight, conv.bias]
    for a, b in zip(torch.autograd.grad(once, params, g),
                    torch.autograd.grad(plain, params, g)):
        assert torch.equal(a, b)
