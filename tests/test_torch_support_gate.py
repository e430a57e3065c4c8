"""The port's CNN-support gate in sphere_segment against the JAX
package's, on tests/test_support_gate.py's point grids and CNN masks.

The port takes the RANSAC quadruples as an argument; here it gets the
JAX package's own draw (models/segment.ransac_indices, utils/jax_prng.py),
so both packages fit from the same hypotheses.  Each regime of the JAX
test runs through both: the masks must agree on at least 99.9 % of the
points (residuals that sit within float32 rounding of a threshold may
differ), the support must engage or stay locked out in both, and the
radius must agree within 1e-3 mm (tests/test_torch_signal_models.py's
tolerance for the same function) and sit in the JAX test's 24-26 mm.
The rescue regime needs the arthritic cohort (chip_smoke.py phase 11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoulder_tpu.models import segment as jseg
from shoulder_tpu_torch.models import segment as tseg

from test_support_gate import _cap_points, _mask_where

# (cap, CNN mask) of each regime
REGIMES = {
    "widens_to_flattened_flank": (dict(flatten_depth=5.0),
                                  lambda p: p <= 1.1),
    "garbage_cnn_locked_out": ({}, lambda p: p <= 1.35),
    "consensus_refits_on_smooth_erosion": (
        dict(flatten_depth=5.0, flatten_from=0.2, flatten_all_theta=True),
        lambda p: p <= 1.1),
}


def _both(pts, cnn=None):
    """((mask, radius) of the JAX package, (mask, radius) of the port)."""
    r, c = pts.shape[:2]
    hyp = tseg.ransac_indices(int(0.4 * r) * c, "cpu")
    kw = {} if cnn is None else dict(init_mask=cnn, support_mask=cnn)
    jm, jr, _, _ = jseg.sphere_segment(
        pts, **{k: jnp.asarray(v) for k, v in kw.items()})
    tm, tr, _, _ = tseg.sphere_segment(
        torch.as_tensor(pts), hyp,
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    return (np.asarray(jm), float(jr)), (tm.numpy(), float(tr))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_support_gate_matches_jax(regime):
    cap_kw, pred = REGIMES[regime]
    pts, phi = _cap_points(**cap_kw)
    cnn = _mask_where(phi, 64, pred)
    (j0, jr0), (t0, tr0) = _both(pts)
    (j1, jr1), (t1, tr1) = _both(pts, cnn)
    for got, want in ((t0, j0), (t1, j1)):
        assert (got == want).mean() >= 0.999
    # the same engage / lock-out decision
    assert (t1 != t0).any() == (j1 != j0).any()
    for got, want in ((tr0, jr0), (tr1, jr1)):
        assert got == pytest.approx(want, abs=1e-3)
    if regime == "widens_to_flattened_flank":
        assert 24.0 < tr0 < 26.0
        assert t1.sum() > t0.sum()
        assert t1[int(np.searchsorted(phi, 1.1)) + 1:].sum() == 0
    elif regime == "garbage_cnn_locked_out":
        assert np.array_equal(t1, t0)
    else:
        assert t0.mean() > 0.12
