"""The sphere segmenter's passes over the points (ops/sphere.py) on the
CPU: each plain version against the JAX package's arithmetic, the
segmenter that composes them against the JAX package's, the plain path's
batch invariance, the kernels' arithmetic as a model in PyTorch, and the
kernel wrappers' argument checks.

The JAX package's `tukey_score` and `fit` are closures inside its
`sphere_segment` (shoulder_tpu/models/segment.py:145-177): the score is
written here in jnp as it is there, and the fit is the JAX package's
`utils.fits.fit_sphere`, the same centred normal equations.  The kernels
themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py phase 5c); `score_model` and `fit_model` below follow
csrc/sphere_score.cu and csrc/sphere_fit.cu step by step (the
reciprocal of the scale, the 14 centred sums and their places in the
normal matrix), with float64 sums where the kernels sum in a fixed
float32 order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoulder_tpu.models import segment as jseg
from shoulder_tpu.utils import fits as jfits
from shoulder_tpu_torch.models import segment as tseg
from shoulder_tpu_torch.ops import sphere

from test_torch_signal_models import _dome_image

T = torch.as_tensor
TOL_MM = 1e-3  # tests/test_torch_signal_models.py's, for the same function


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row_prior(r, c):
    """The JAX package's selection-only row prior (segment.py:168-170)."""
    row_idx = jnp.repeat(jnp.arange(r), c).astype(jnp.float32)
    t_row = jnp.clip((row_idx - 0.45 * r) / (0.30 * r), 0.0, 1.0)
    return 1.0 - 0.8 * t_row * t_row * (3.0 - 2.0 * t_row)


def _jax_tukey_score(pts, w_row, radius, center, scale):
    """The JAX package's tukey_score (segment.py:174-177), one hypothesis."""
    resid = jnp.abs(jnp.linalg.norm(pts - center, axis=1) - radius)
    u = jnp.minimum(resid / scale, 1.0)
    return jnp.sum(w_row * (1.0 - u**2) ** 2)


def _hypotheses(pts, r, c):
    """The port's RANSAC spheres on JAX's draw, (H,) and (H, 3)."""
    hyp = tseg.ransac_indices(int(0.4 * r) * c, "cpu")
    quads = pts[hyp]
    a4 = torch.cat([2.0 * quads, torch.ones(quads.shape[:-1] + (1,))], -1)
    sol = torch.linalg.solve_ex(a4, torch.sum(quads**2, -1)).result
    rad = torch.sqrt(torch.clamp(sol[:, 3] + torch.sum(sol[:, :3] ** 2, -1),
                                 min=1e-9))
    return rad, sol[:, :3]


def _w_row(r, c):
    return T(np.array(_row_prior(r, c)))


def score_model(pts, w_row, h_rad, h_cen, scale):
    """csrc/sphere_score.cu's arithmetic: float32 terms with the residual
    times the scale's reciprocal, summed in float64."""
    inv = 1.0 / (scale if torch.is_tensor(scale)
                 else torch.tensor(scale, dtype=torch.float32))
    d = pts[..., None, :, :] - h_cen[..., :, None, :]
    d = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                   + d[..., 2] * d[..., 2])
    inv = inv[..., None, None] if inv.dim() else inv
    u = torch.clamp(torch.abs(d - h_rad[..., None]) * inv, max=1.0)
    t = 1.0 - u * u
    return (w_row * (t * t)).double().sum(-1).float()


def fit_model(pts, weights, w=None, radius=None, center=None, scale=None):
    """csrc/sphere_fit.cu's passes: (sums (..., 5), mean (..., 3), normal
    (..., 4, 5)) as sphere.sphere_fit_kernel returns them, the kernel's
    float32 terms summed in float64."""
    x, y, z = pts.unbind(-1)
    if weights == sphere.GIVEN:
        wt, sres = w, None
    else:
        dx, dy, dz = (x - center[..., 0:1], y - center[..., 1:2],
                      z - center[..., 2:3])
        sres = torch.sqrt(dx * dx + dy * dy + dz * dz) - radius[..., None]
        inv = 1.0 / (scale if torch.is_tensor(scale)
                     else torch.full(radius.shape, scale))
        u = torch.clamp(torch.abs(sres) * inv[..., None], max=1.0)
        t = 1.0 - u * u
        wt = t * t

    def total(v):
        return v.double().sum(-1).float()

    zero = torch.zeros_like(total(wt))
    if weights == sphere.SIGMA:
        sums = torch.stack([total(wt), zero, zero, zero,
                            total(wt * (sres * sres))], -1)
        return sums, None, None
    sums = torch.stack([total(wt), total(x * wt), total(y * wt),
                        total(z * wt), zero], -1)
    den = torch.clamp(sums[..., 0], min=1.0)
    m = sums[..., 1:4] / den[..., None]
    qx, qy, qz = (x - m[..., 0:1], y - m[..., 1:2], z - m[..., 2:3])
    wx, wy, wz = qx * wt, qy * wt, qz * wt
    f = qx * qx + qy * qy + qz * qz
    tt = [total(v) for v in (wt, wx, wy, wz, wx * qx, wx * qy, wx * qz,
                             wy * qy, wy * qz, wz * qz, wt * f, wx * f,
                             wy * f, wz * f)]
    qq = [[tt[4], tt[5], tt[6]], [tt[5], tt[7], tt[8]],
          [tt[6], tt[8], tt[9]]]
    rows = []
    for i in range(3):
        rows.append(torch.stack([4.0 * qq[i][0], 4.0 * qq[i][1],
                                 4.0 * qq[i][2], 2.0 * tt[1 + i],
                                 2.0 * tt[11 + i]], -1))
    rows.append(torch.stack([2.0 * tt[1], 2.0 * tt[2], 2.0 * tt[3], tt[0],
                             tt[10]], -1))
    return sums, m, torch.stack(rows, -2)


def _bones(n=3, seeds=(12, 13, 14)):
    """(n, R, C, 3) dome images, one seed each."""
    return np.stack([_dome_image(s) for s in seeds[:n]])


def test_plain_score_matches_jax_tukey_score():
    pts = _dome_image(12)
    r, c = pts.shape[:2]
    flat = T(pts).reshape(-1, 3)
    h_rad, h_cen = _hypotheses(flat, r, c)
    w_row = _w_row(r, c)
    jpts = jnp.asarray(pts.reshape(-1, 3))
    for scale in (0.7, 1.9):
        want = np.asarray(jax.vmap(
            lambda rad, cen: _jax_tukey_score(jpts, jnp.asarray(w_row.numpy()),
                                              rad, cen, scale))(
            jnp.asarray(h_rad.numpy()), jnp.asarray(h_cen.numpy())))
        got = sphere.score_plain(flat, w_row, h_rad, h_cen, scale).numpy()
        assert np.isfinite(want).all() and want.max() > 100.0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("weights", ["heur", "mask", "tukey"])
def test_plain_fit_matches_jax_fit(weights):
    pts = _dome_image(13)
    r, c = pts.shape[:2]
    flat = T(pts).reshape(-1, 3)
    rng = np.random.default_rng(5)
    if weights == "heur":
        w = (np.arange(r * c) // c < int(0.3 * r)).astype(np.float32)
    elif weights == "mask":
        w = (rng.random(r * c) < 0.4).astype(np.float32)
    else:
        # the IRLS body's weights (segment.py:251-261) from a perturbed
        # sphere, in jnp
        cen, rad, scale = np.array([2.3, -0.6, 275.4], np.float32), 23.6, 1.0
        resid = jnp.abs(jnp.linalg.norm(jnp.asarray(pts.reshape(-1, 3))
                                        - cen, axis=1) - rad)
        u = jnp.minimum(resid / scale, 1.0)
        w = np.array((1.0 - u**2) ** 2)
        got_w = sphere.tukey_plain(flat, T(np.float32(rad)), T(cen),
                                   T(np.float32(scale)))
        np.testing.assert_allclose(got_w.numpy(), w, atol=1e-6)
    j_rad, j_cen = jfits.fit_sphere(jnp.asarray(pts.reshape(-1, 3)),
                                    jnp.asarray(w))
    rad, cen = sphere.solve(*sphere.moments_plain(flat, T(w)), torch.eye(4))
    assert float(rad) == pytest.approx(float(j_rad), abs=1e-4)
    np.testing.assert_allclose(cen.numpy(), np.asarray(j_cen), atol=1e-4)


@pytest.mark.parametrize("support", [False, True])
def test_sphere_segment_batch_pinned_to_jax(support):
    """A batch of two domes (12 IRLS passes) through the port, each bone
    against the JAX package's sphere_segment on its draw, within
    tests/test_torch_signal_models.py's tolerances."""
    pts = _bones(2, seeds=(13, 14))
    r, c = pts.shape[1:3]
    hyp = tseg.ransac_indices(int(0.4 * r) * c, "cpu")
    sup = np.zeros((2, r, c), np.float32)
    sup[:, : int(0.45 * r)] = 1.0
    kw = dict(init_mask=sup, support_mask=sup) if support else {}
    got = tseg.sphere_segment(T(pts), hyp, 12, 2.0, 0.3,
                              **{k: T(v) for k, v in kw.items()})
    for b in range(2):
        jm, jr, jc, jres = jseg.sphere_segment(
            pts[b], 12, 2.0, 0.3, **{k: jnp.asarray(v[b])
                                     for k, v in kw.items()})
        assert (got[0][b].numpy() == np.asarray(jm)).mean() >= 0.999
        assert float(got[1][b]) == pytest.approx(float(jr), abs=TOL_MM)
        np.testing.assert_allclose(got[2][b].numpy(), np.asarray(jc),
                                   atol=TOL_MM)
        assert float(got[3][b]) == pytest.approx(float(jres), abs=TOL_MM)


def test_plain_path_is_batch_invariant():
    pts = _bones()
    r, c = pts.shape[1:3]
    hyp = tseg.ransac_indices(int(0.4 * r) * c, "cpu")
    sup = np.zeros((3, r, c), np.float32)
    sup[:, : int(0.45 * r)] = 1.0
    kw = dict(init_mask=T(sup), support_mask=T(sup))
    batch = tseg.sphere_segment(T(pts), hyp, 12, 2.0, 0.3, **kw)
    for b in (0, 2):
        alone = tseg.sphere_segment(T(pts[b:b + 1]), hyp, 12, 2.0, 0.3,
                                    **{k: v[b:b + 1] for k, v in kw.items()})
        for x, y in zip(alone, batch):
            assert torch.equal(x[0], y[b])


def test_score_model_matches_plain():
    pts = T(_bones(2)).reshape(2, -1, 3)
    r, c = 64, 128
    hyps = [_hypotheses(pts[b], r, c) for b in range(2)]
    h_rad = torch.stack([h[0] for h in hyps])
    h_cen = torch.stack([h[1] for h in hyps])
    w_row = _w_row(r, c)
    for scale in (0.7, T([0.7, 1.6])):
        want = sphere.score_plain(pts, w_row, h_rad, h_cen, scale)
        got = score_model(pts, w_row, h_rad, h_cen, scale)
        rel = (got - want).abs() / want.abs().clamp(min=1.0)
        assert float(rel.max()) < 1e-5


@pytest.mark.parametrize("kind", ["given", "tukey", "sigma"])
def test_fit_model_matches_plain(kind):
    """The kernel's sums and their places in the normal matrix against the
    plain moments, on a batch of two bones."""
    pts = T(_bones(2)).reshape(2, -1, 3)
    eye4 = torch.eye(4)
    radius, center = T([23.7, 24.2]), T([[2.2, -0.9, 275.3],
                                         [1.8, -1.2, 274.6]])
    scale = T([1.0, 1.4])
    if kind == "given":
        w = (torch.arange(pts.shape[1]) // 128 < 19).float().expand(2, -1)
        sums, mean, normal = fit_model(pts, sphere.GIVEN, w=w)
        want_mean, want_normal = sphere.moments_plain(pts, w)
    elif kind == "tukey":
        sums, mean, normal = fit_model(pts, sphere.TUKEY, radius=radius,
                                       center=center, scale=scale)
        w = sphere.tukey_plain(pts, radius, center, scale)
        want_mean, want_normal = sphere.moments_plain(pts, w)
    else:
        sums, mean, normal = fit_model(pts, sphere.SIGMA, radius=radius,
                                       center=center, scale=1.0)
        w_sum, w_sres2 = sphere.sigma_sums_plain(pts, radius, center, 1.0)
        torch.testing.assert_close(sums[:, 0], w_sum, rtol=1e-5, atol=0)
        torch.testing.assert_close(sums[:, 4], w_sres2, rtol=1e-5, atol=1e-7)
        assert mean is None and normal is None
        return
    assert torch.equal(sums[:, 4], torch.zeros(2))
    torch.testing.assert_close(sums[:, 0], w.sum(-1), rtol=1e-5, atol=0)
    torch.testing.assert_close(mean, want_mean, rtol=0, atol=1e-4)
    # float32 sums over 8192 points: each entry within 1e-4 of the
    # matrix's largest (the plain sums and the model's differ by ~1.5e-5)
    scale_n = want_normal.abs().amax(dim=(-2, -1), keepdim=True)
    assert float(((normal - want_normal).abs() / scale_n).max()) < 1e-4
    got_r, got_c = sphere.solve(mean, normal, eye4)
    want_r, want_c = sphere.solve(want_mean, want_normal, eye4)
    torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-4)
    torch.testing.assert_close(got_c, want_c, rtol=0, atol=1e-4)


def test_irls_fallback_takes_the_top_rows_fit():
    """A sphere far from every point gives Tukey weights that sum to 0:
    the IRLS pass takes the top-rows weights' moments, on the CPU as the
    JAX package's jnp.where does."""
    pts = T(_bones(2)).reshape(2, -1, 3)
    w_heur = (torch.arange(pts.shape[1]) // 128 < 19).float().expand(2, -1)
    heur = sphere.fit_moments(pts, w_heur)
    radius, center = T([23.7, 24.0]), T([[2.2, -0.9, 275.3],
                                         [500.0, 0.0, 0.0]])
    mean, normal = sphere.irls_moments(pts, radius, center, T([1.0, 1.0]),
                                       w_heur, heur)
    assert torch.equal(mean[1], heur[0][1])
    assert torch.equal(normal[1], heur[1][1])
    assert not torch.equal(mean[0], heur[0][0])


def test_kernel_wrappers_check_their_arguments():
    pts = torch.zeros(2, 100, 3)
    w_row = torch.ones(100)
    h_rad, h_cen = torch.full((2, 5), 20.0), torch.zeros(2, 5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        sphere.sphere_score_kernel(pts, w_row, h_rad, h_cen, 1.0)
    with pytest.raises(ValueError, match="points"):
        sphere.sphere_score_kernel(pts.double(), w_row, h_rad, h_cen, 1.0)
    with pytest.raises(ValueError, match="points"):
        sphere.sphere_score_kernel(pts[..., :2], w_row, h_rad, h_cen, 1.0)
    with pytest.raises(ValueError, match="points"):
        sphere.sphere_score_kernel(pts.transpose(0, 1), w_row, h_rad, h_cen,
                                   1.0)
    with pytest.raises(ValueError, match="w_row"):
        sphere.sphere_score_kernel(pts, w_row[:50], h_rad, h_cen, 1.0)
    with pytest.raises(ValueError, match="h_cen"):
        sphere.sphere_score_kernel(pts, w_row, h_rad, h_cen[:, :4], 1.0)
    with pytest.raises(ValueError, match="scale"):
        sphere.sphere_score_kernel(pts, w_row, h_rad, h_cen, torch.ones(3))
    with pytest.raises(ValueError, match="CUDA"):
        sphere.sphere_fit_kernel(pts, sphere.GIVEN, w=torch.ones(2, 100))
    with pytest.raises(ValueError, match="CUDA"):
        sphere.sphere_fit_kernel(pts, sphere.GIVEN,
                                 w=torch.ones(100).expand(2, 100))
    with pytest.raises(ValueError, match="w must"):
        sphere.sphere_fit_kernel(pts, sphere.GIVEN, w=torch.ones(2, 99))
    with pytest.raises(ValueError, match="w must"):
        sphere.sphere_fit_kernel(pts, sphere.GIVEN,
                                 w=torch.ones(100, 2).t())
    with pytest.raises(ValueError, match="radius"):
        sphere.sphere_fit_kernel(pts, sphere.TUKEY, radius=torch.ones(3),
                                 center=torch.zeros(2, 3), scale=1.0)
    with pytest.raises(ValueError, match="center"):
        sphere.sphere_fit_kernel(pts, sphere.SIGMA, radius=torch.ones(2),
                                 center=torch.zeros(2, 3).double(), scale=1.0)
    with pytest.raises(ValueError, match="weights"):
        sphere.sphere_fit_kernel(pts, 7, w=torch.ones(2, 100))
