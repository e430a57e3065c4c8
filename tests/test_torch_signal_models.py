"""The port's signal ops, fits, forest, rays, rectangle and sphere
segmenter vs shoulder_tpu's, on the same seeded inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from shoulder_tpu.models import forest as jforest
from shoulder_tpu.models import segment as jseg
from shoulder_tpu.ops import rays as jrays
from shoulder_tpu.ops import rect as jrect
from shoulder_tpu.ops import signal as jsig
from shoulder_tpu.utils import fits as jfits
from shoulder_tpu_torch.models import forest as tforest
from shoulder_tpu_torch.models import segment as tseg
from shoulder_tpu_torch.ops import rays as trays
from shoulder_tpu_torch.ops import rect as trect
from shoulder_tpu_torch.ops import signal as tsig
from shoulder_tpu_torch.utils import fits as tfits

T = torch.as_tensor


def _rows(seed, n_rows=6, n=512, smooth=15):
    """Noise rows; smooth=0 raw, smooth<0 a few random sinusoids (a
    groove-like radius profile with well under 64 local maxima)."""
    rng = np.random.default_rng(seed)
    if smooth < 0:
        t = np.linspace(0, 2 * np.pi, n, endpoint=False)
        f = rng.integers(1, 12, (n_rows, 4, 1))
        a = rng.normal(size=(n_rows, 4, 1))
        ph = rng.uniform(0, 2 * np.pi, (n_rows, 4, 1))
        return (a * np.sin(f * t + ph)).sum(1).astype(np.float32)
    x = rng.normal(size=(n_rows, n))
    if smooth:
        x = scipy.signal.savgol_filter(x, smooth, 2, axis=1)
    return x.astype(np.float32)


@pytest.mark.parametrize("window", [10, 3])
def test_savgol_filter_matches_jax(window):
    x = _rows(0, smooth=0).cumsum(axis=1)
    ref = np.asarray(jsig.savgol_filter(x, window, 1))
    got = tsig.savgol_filter(T(x), window, 1).numpy()
    # same moving-sum formula; float32 cumsums of ~20-magnitude sums
    assert np.allclose(got, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("seed,cap,smooth", [(0, 64, -1), (1, 64, -1),
                                             (2, None, 15), (3, 8, 0)])
def test_find_peaks_matches_jax(seed, cap, smooth):
    """cap 8 on raw noise overflows the candidate slots: the overflow
    flag and the positional truncation must match too."""
    x = _rows(seed, smooth=smooth)
    kw = dict(height=-10.0, prominence=0.05, width=0.1, max_peaks=16,
              cand_cap=cap)
    ref = jax.vmap(lambda r: jsig.find_peaks(r, method="dense", **kw))(x)
    got = tsig.find_peaks(T(x), **kw)
    for key in ("idx", "valid", "n_peaks", "overflow"):
        assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key
    for key in ("prominences", "widths", "width_heights"):
        assert np.allclose(got[key].numpy(), np.asarray(ref[key]),
                           atol=1e-4), key
    assert bool(got["overflow"].any()) == (cap == 8)
    assert bool(got["valid"].any())


def test_rbf_changepoint_matches_jax():
    rng = np.random.default_rng(4)
    for n, t0 in [(58, 20), (40, 31), (120, 60)]:
        sig = np.concatenate([rng.normal(600, 15, t0),
                              rng.normal(420, 15, n - t0)]).astype(np.float32)
        ref = int(jsig.rbf_changepoint_1bkp(sig))
        assert int(tsig.rbf_changepoint_1bkp(T(sig))) == ref
        assert abs(ref - t0) <= 2


def test_fill_from_scatter_matches_jax_dense_rank():
    """Non-monotone and out-of-range dest: the dense-rank semantics."""
    rng = np.random.default_rng(5)
    n, m, c = 300, 128, 6
    rows = rng.normal(size=(4, n, c)).astype(np.float32)
    dest = np.stack([
        np.sort(rng.integers(0, m, n)),            # monotone
        rng.integers(-5, m + 5, n),                # arbitrary
        np.maximum.accumulate(rng.integers(0, m, n)) - rng.integers(0, 3, n),
        np.full(n, m + 1),                         # all dropped
    ]).astype(np.int32)
    init = rows[:, 0]
    ref = np.stack([np.asarray(jsig.fill_from_scatter(
        jnp.asarray(dest[b]), jnp.asarray(rows[b]), m, jnp.asarray(init[b]),
        dense=True)) for b in range(4)])
    got = tsig.fill_from_scatter(T(dest).long(), T(rows), m, T(init)).numpy()
    # a pure row selection: any difference would be a wrong row
    assert np.allclose(got, ref, atol=1e-5)


def test_interp_ascending_matches_jax():
    rng = np.random.default_rng(6)
    n_rows, n, m = 5, 200, 256
    xp = np.sort(rng.uniform(-3.0, 3.0, (n_rows, n)), axis=1).astype(np.float32)
    xp[1, 50:60] = xp[1, 50]                        # repeated knots
    fp = rng.normal(size=(n_rows, n)).astype(np.float32)
    x0 = xp[:, 0].copy()
    step = ((xp[:, -1] - x0) / (m - 1)).astype(np.float32)
    step[2] = 0.0                                   # degenerate grid
    x = (x0[:, None] + np.arange(m, dtype=np.float32)[None] * step[:, None])
    x = x.astype(np.float32)
    ref = np.stack([np.asarray(jsig.interp_ascending(
        x[r], xp[r], fp[r], grid=(x0[r], step[r]))) for r in range(n_rows)])
    got = tsig.interp_ascending(T(x), T(xp), T(fp), grid=(T(x0), T(step)))
    # the same knots and the same guarded formula; 1e-5 allows float
    # contraction differences of the one interpolation step
    assert np.allclose(got.numpy(), ref, atol=1e-5)


def test_kde_linear_argmax_matches_jax():
    rng = np.random.default_rng(7)
    s = rng.uniform(-np.pi, np.pi, 400).astype(np.float32)
    w = (rng.random(400) < 0.3).astype(np.float32)
    grid = np.linspace(-np.pi, np.pi, 1024).astype(np.float32)
    ref, ref_d = jsig.kde_linear_argmax(jnp.asarray(s), jnp.asarray(w),
                                        jnp.asarray(grid))
    got, got_d = tsig.kde_linear_argmax(T(s), T(w), T(grid))
    ref_d = np.asarray(ref_d)
    # the densities are 120-term float32 sums taken in another order, so
    # the argmax may move along a flat top: it must be a maximum of JAX's
    # density up to that rounding
    assert np.allclose(got_d.numpy(), ref_d, atol=1e-4)
    k = int(np.flatnonzero(grid == float(got))[0])
    assert ref_d[k] >= ref_d.max() - 1e-4
    assert abs(float(got) - float(ref)) < 0.05


def test_forest_predict_proba_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(700, 9)).astype(np.float32)
    ref = np.asarray(jforest.predict_proba(jforest.load_params(), x))
    got = tforest.predict_proba(tforest.load_params("cpu"), T(x)).numpy()
    # identical comparisons pick identical leaves; the sums over 40
    # trees may round differently in the last place
    assert np.allclose(got, ref, atol=1e-6)


def test_fits_match_jax():
    rng = np.random.default_rng(9)
    pts = (rng.normal(size=(400, 3)) * [1.0, 3.0, 20.0]
           + [5.0, -2.0, 80.0]).astype(np.float32)
    w = (rng.random(400) < 0.7).astype(np.float32)
    for jf, tf in [(jfits.fit_line, tfits.fit_line),
                   (jfits.fit_plane, tfits.fit_plane)]:
        jc, jd = jf(pts, w)
        tc, td = tf(T(pts), T(w))
        # weighted means and scatter matrices of 400 points, summed in
        # another float32 order
        assert np.allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
        assert np.allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    cov = np.cov(pts.T).astype(np.float32)
    jv, jvec = jfits.eigh3(cov)
    tv, tvec = tfits.eigh3(T(cov))
    # the closed form loses the small eigenvalues to float32 cancellation
    # against the largest one (det and trace taken in another order), so
    # the tolerance scales with the largest
    assert np.allclose(tv.numpy(), np.asarray(jv), atol=1e-5 * float(jv[-1]))
    assert np.allclose(np.abs(tvec.numpy()), np.abs(np.asarray(jvec)),
                       atol=1e-4)

    d = rng.normal(size=(500, 3))
    sph = (24.0 * d / np.linalg.norm(d, axis=1, keepdims=True)
           + [3.0, 1.0, 250.0] + rng.normal(0, 0.05, (500, 3)))
    sph = sph.astype(np.float32)
    jr, jcen = jfits.fit_sphere(sph)
    tr, tcen = tfits.fit_sphere(T(sph))
    # float32 normal equations solved by two LU implementations
    assert float(tr) == pytest.approx(float(jr), abs=1e-3)
    assert np.allclose(tcen.numpy(), np.asarray(jcen), atol=1e-3)

    t = rng.uniform(0, 2 * np.pi, 300)
    ell = np.stack([14.0 * np.cos(t), 9.0 * np.sin(t)], 1) @ np.array(
        [[0.8, 0.6], [-0.6, 0.8]]) + [40.0, -12.0]
    ell = (ell + rng.normal(0, 0.05, ell.shape)).astype(np.float32)
    we = (rng.random(300) < 0.8).astype(np.float32)
    jres = jfits.fit_ellipse(ell, we)
    tres = tfits.fit_ellipse(T(ell), T(we))
    assert np.allclose(tres[0].numpy(), np.asarray(jres[0]), atol=1e-3)
    for a, b in zip(tres[1:], jres[1:]):
        assert float(a) == pytest.approx(float(b), abs=1e-3)


def test_rays_and_rect_match_jax(tiny_spec):
    s = tiny_spec
    v = (s.vertices @ s.obb_transform[:3, :3].T.astype(np.float32)
         + s.obb_transform[:3, 3].astype(np.float32)).astype(np.float32)
    o = np.tile(v[: s.n_verts].mean(0), (4, 1)).astype(np.float32)
    d = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0.6, 0.8, 0]],
                 np.float32)
    jp, jt, jh = jrays.first_hits(v, s.faces, o, d)
    tp, tt, th = trays.first_hits(T(v), T(s.faces), T(o), T(d))
    assert np.array_equal(th.numpy(), np.asarray(jh)) and th.all()
    # hit points and rectangles: the same arithmetic, 3-term dot products
    # and matmuls summed in another order (1e-4 mm at ~300 mm coordinates)
    assert np.allclose(tp.numpy(), np.asarray(jp), atol=1e-4)

    rng = np.random.default_rng(10)
    ang = rng.uniform(0, 2 * np.pi, (5, 300))
    pts = np.stack([30 * np.cos(ang), 12 * np.sin(ang)], -1)
    pts = (pts @ np.array([[0.6, -0.8], [0.8, 0.6]]) + 5.0).astype(np.float32)
    ref = jax.vmap(jrect.min_rotated_rect)(jnp.asarray(pts))
    got = trect.min_rotated_rect(T(pts))
    for a, b in zip(got, ref):
        assert np.allclose(a.numpy(), np.asarray(b), atol=1e-4)
    out, _ = jrect.end_slab_mask(pts[0], jax.tree.map(lambda x: x[0], ref), 0.9)
    tout, _ = trect.end_slab_mask(T(pts[0]), trect.RotatedRect(
        *(x[0] for x in got)), 0.9)
    assert np.array_equal(tout.numpy(), np.asarray(out))
    rid = np.asarray(jrect.cyclic_runs(out, 8))
    assert np.array_equal(trect.cyclic_runs(tout, 8).numpy(), rid)
    jc = jrect.run_chord_centroids(pts[0], rid, None, 8)
    tc = trect.run_chord_centroids(T(pts[0]), T(rid).long(), 8)
    assert np.allclose(tc[0].numpy(), np.asarray(jc[0]), atol=1e-4)
    assert np.array_equal(tc[2].numpy(), np.asarray(jc[2]))


def test_longest_cyclic_run_matches_jax():
    rng = np.random.default_rng(11)
    m = rng.random((64, 96)) < 0.6
    m[3] = True
    m[4] = False
    m[5, :10] = m[5, -10:] = True             # a run across the seam
    ref = np.asarray(jseg._longest_cyclic_run_per_row(jnp.asarray(m)))
    assert np.array_equal(tseg._longest_cyclic_run_per_row(T(m)).numpy(), ref)


def _dome_image(seed, r=64, c=128):
    """(r, c, 3) polar surface points: a 24 mm spherical dome on a shaft."""
    rng = np.random.default_rng(seed)
    th = np.linspace(-np.pi, np.pi, c, endpoint=False)
    z = np.linspace(300.0, 240.0, r)
    cen = np.array([2.0, -1.0, 275.0])
    rad_sph = np.sqrt(np.clip(24.0**2 - (z - cen[2]) ** 2, 0, None))
    rad = np.where(z > 262.0, rad_sph, 15.0 + 0.2 * (262.0 - z))
    rad = rad[:, None] + 1.5 * np.cos(3 * th)[None] * (z < 266.0)[:, None]
    rad = rad + rng.normal(0, 0.02, (r, c))
    x = cen[0] + rad * np.cos(th)[None]
    y = cen[1] + rad * np.sin(th)[None]
    return np.stack([x, y, np.broadcast_to(z[:, None], (r, c))],
                    -1).astype(np.float32)


@pytest.mark.parametrize("support", [False, True])
def test_sphere_segment_matches_jax_given_its_draw(support):
    """The port takes the RANSAC quadruples as an argument; given JAX's own
    draw it must reproduce JAX's segmentation."""
    pts = _dome_image(12)
    r, c = pts.shape[:2]
    hyp = np.asarray(jax.random.randint(jax.random.PRNGKey(17), (128, 4), 0,
                                        int(0.4 * r) * c))
    kw = {}
    if support:
        sup = np.zeros((r, c), np.float32)
        sup[: int(0.45 * r)] = 1.0
        kw = dict(init_mask=sup, support_mask=sup)
    jm, jr, jc, jres = jseg.sphere_segment(
        pts, 6, 2.0, 0.3,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tm, tr, tc, tres = tseg.sphere_segment(
        T(pts), T(hyp).long(), 6, 2.0, 0.3, **{k: T(v) for k, v in kw.items()})
    # the masks threshold identical-formula residuals: equal except where a
    # residual sits within float32 rounding of a threshold
    assert (tm.numpy() == np.asarray(jm)).mean() >= 0.999
    assert 0.1 < float(tm.mean()) < 0.6
    assert float(tr) == pytest.approx(float(jr), abs=1e-3)
    assert np.allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
    assert float(tres) == pytest.approx(float(jres), abs=1e-3)
