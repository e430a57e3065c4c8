"""Articular-surface segmentation over the polar-radius image (PyTorch).

Port of shoulder_tpu/models/segment.py: `sphere_segment`, the robust
sphere-consensus segmenter (RANSAC init, Tukey IRLS, first-departure rim
cut, CNN support gate with its rescue branch), and the longest cyclic run
per row.

The 128 RANSAC quadruples are JAX's own draw,
`jax.random.randint(PRNGKey(17), (128, 4), 0, top_n)`, reproduced bit for
bit in numpy by utils/jax_prng.py (`ransac_indices`).  The caller passes
them in (`hyp_idx`), so tests can substitute their own.
"""

from __future__ import annotations

import functools

import torch

from shoulder_tpu_torch.utils import fits, jax_prng

N_HYP = 128
# hypotheses scored at a time: the score's largest intermediate is
# (bones, HYP_CHUNK, points, 3) float32, 100 MB per bone at DEFAULT_CONFIG's
# 262,144 points, where all 130 at once would take 409 MB per bone
HYP_CHUNK = 32


def ransac_indices(top_n: int, device, seed: int = 17):
    """(N_HYP, 4) int64 RANSAC quadruples in [0, top_n): the JAX package's
    draw `jax.random.randint(PRNGKey(seed), (128, 4), 0, top_n)`, made on
    the host and copied to `device` once per (top_n, device, seed) per
    process (the copy waits for the device); callers share the tensor and
    must not write to it."""
    return _ransac_indices(top_n, str(torch.device(device)), seed)


@functools.lru_cache(maxsize=None)
def _ransac_indices(top_n: int, device: str, seed: int):
    idx = jax_prng.randint(seed, (N_HYP, 4), 0, top_n)
    return torch.from_numpy(idx).to(device=device, dtype=torch.int64)


def _longest_cyclic_run_per_row(mask):
    """Keep only the longest contiguous cyclic run of True in each row
    of mask (R, C).

    The winning run maximizes (length, -cyclic start order counted from
    the row's first False); a run that wraps the seam starts at its tail
    segment's start.
    """
    n = mask.shape[-1]
    m = mask
    i = torch.arange(n, device=mask.device)
    neg = torch.where(~m, i, -1)
    prev_false = torch.cummax(neg, dim=-1).values                   # -1 none
    pos = torch.where(~m, i, n)
    next_false = torch.flip(
        torch.cummin(torch.flip(pos, [-1]), dim=-1).values, [-1])  # n none
    runlen = next_false - prev_false - 1
    first_false = pos.amin(dim=-1, keepdim=True)
    last_false = neg.amax(dim=-1, keepdim=True)
    has_false = first_false < n
    wrap = has_false & m[..., :1] & m[..., -1:]
    wrap_len = first_false + (n - 1 - last_false)
    in_head = m & (i < first_false)
    in_tail = m & (i > last_false)
    in_wrap = wrap & (in_head | in_tail)
    runlen = torch.where(in_wrap, wrap_len, runlen)
    start = torch.where(in_wrap, last_false + 1, prev_false + 1)
    start_cyc = torch.where(has_false, torch.remainder(start - first_false, n), 0)
    key = torch.where(m, runlen * (n + 1) + (n - start_cyc), -1)
    best = key.amax(dim=-1, keepdim=True)
    return m & (key == best) & (best >= 0)


def sphere_segment(
    points,
    hyp_idx,
    iters: int = 12,
    tol_mm: float = 2.0,
    init_top_rows: float = 0.3,
    init_mask=None,
    support_mask=None,
    support_tol_factor: float = 3.0,
    support_min_disagree: float = 0.05,
    support_max_disagree: float = 0.35,
    support_min_recall: float = 0.5,
    support_rescue_max_frac: float = 0.12,
):
    """Segment the articular surface by robust sphere consensus.

    Args:
      points: (..., R, C, 3) surface points in the OBB frame, row 0 the
        most proximal slice; leading dimensions are a bone batch, each
        bone segmented on its own (JAX vmaps the same function).
      hyp_idx: (128, 4) int indices into the first int(0.4 R) * C points,
        the RANSAC quadruples (see the module note), the same for every
        bone of a batch.
      iters: IRLS iterations after the hypothesis pick.
      tol_mm: base tolerance in mm; strict inliers use 0.6x this.
      init_top_rows: fraction of top rows seeding the least-squares
        hypothesis.
      init_mask: optional (..., R, C) {0,1} seed (the UNet mask) that
        competes as one more hypothesis.
      support_mask: optional (..., R, C) {0,1} CNN evidence that may widen
        the final mask up to support_tol_factor * tol_mm from the sphere,
        when the gate (min/max disagree, min recall, or the rescue below
        support_rescue_max_frac of the image) lets it.

    Returns (mask (..., R, C) float {0,1}, radius (...,), center (..., 3),
    mean_resid (...,)).
    """
    r, c = points.shape[-3], points.shape[-2]
    lead = points.shape[:-3]
    pts = points.reshape(lead + (r * c, 3))                 # (..., P, 3)
    dt, dev = pts.dtype, pts.device
    eye4 = torch.eye(4, dtype=dt, device=dev)
    ones = torch.ones(pts.shape[:-1] + (1,), dtype=dt, device=dev)

    def fit(w):
        """Weighted least-squares sphere of each bone, w (..., P)."""
        mean = (torch.sum(pts * w[..., None], dim=-2)
                / torch.clamp(w.sum(dim=-1), min=1)[..., None])
        q = pts - mean[..., None, :]
        a = torch.cat([2.0 * q, ones], dim=-1)
        f = torch.sum(q**2, dim=-1)
        # A^T W [A | f] in one sum (as utils/fits.fit_sphere)
        normal = fits.gram(a * w[..., None],
                           torch.cat([a, f[..., None]], dim=-1))
        sol = torch.linalg.solve_ex(normal[..., :4] + 1e-6 * eye4,
                                    normal[..., 4]).result
        center = sol[..., :3] + mean
        radius = torch.sqrt(torch.clamp(
            sol[..., 3] + torch.sum(sol[..., :3] ** 2, dim=-1), min=1e-9))
        return radius, center

    # selection-only row prior: scores decay to 0.2x over rows 0.45R..0.75R
    row_of = torch.arange(r * c, device=dev) // c
    t_row = torch.clamp((row_of.to(dt) - 0.45 * r) / (0.30 * r), 0.0, 1.0)
    w_row = 1.0 - 0.8 * t_row * t_row * (3.0 - 2.0 * t_row)

    # RANSAC: minimal 4-point sphere hypotheses from the top rows
    quads = pts.index_select(-2, hyp_idx.reshape(-1)).reshape(
        lead + tuple(hyp_idx.shape) + (3,))                 # (..., H, 4, 3)
    a4 = torch.cat([2.0 * quads, torch.ones(quads.shape[:-1] + (1,),
                                            dtype=dt, device=dev)], dim=-1)
    f4 = torch.sum(quads**2, dim=-1)
    sol = torch.linalg.solve_ex(a4, f4).result
    h_cen = sol[..., :3]
    h_rad = torch.sqrt(torch.clamp(sol[..., 3] + torch.sum(h_cen**2, dim=-1),
                                   min=1e-9))
    # the top-rows least squares and the CNN proposal compete as two more
    w_heur = (row_of < int(init_top_rows * r)).to(dt).expand(lead + (r * c,))
    extra = [fit(w_heur)]
    if init_mask is not None:
        w_seed = init_mask.reshape(lead + (r * c,)).to(dt)
        w_seed = torch.where(w_seed.sum(dim=-1, keepdim=True) < 32, w_heur,
                             w_seed)
        extra.append(fit(w_seed))
    h_rad = torch.cat([h_rad, torch.stack([e[0] for e in extra], dim=-1)],
                      dim=-1)
    h_cen = torch.cat([h_cen, torch.stack([e[1] for e in extra], dim=-2)],
                      dim=-2)

    def dist(center):
        """Distance of every point to each bone's center (..., 3): (..., P)."""
        return torch.linalg.vector_norm(pts - center[..., None, :], dim=-1)

    def pick_best(score_scale):
        """Best hypothesis under the row-weighted Tukey score; score_scale
        a number or one per bone.  HYP_CHUNK hypotheses at a time, so the
        point-to-center differences take (..., HYP_CHUNK, P, 3) and not
        (..., H, P, 3)."""
        ok = (torch.isfinite(h_rad) & torch.isfinite(h_cen).all(dim=-1)
              & (h_rad > 10.0) & (h_rad < 45.0))
        if torch.is_tensor(score_scale):
            score_scale = score_scale[..., None, None]

        def score(rad, cen):
            d = torch.linalg.vector_norm(
                pts[..., None, :, :] - cen[..., :, None, :], dim=-1)
            resid = torch.abs(d - rad[..., None])            # (..., h, P)
            u = torch.clamp(resid / score_scale, max=1.0)
            return torch.sum(w_row * (1.0 - u**2) ** 2, dim=-1)

        scores = torch.cat([score(rad, cen) for rad, cen in zip(
            h_rad.split(HYP_CHUNK, dim=-1), h_cen.split(HYP_CHUNK, dim=-2))],
            dim=-1)
        best = torch.argmax(torch.where(ok, scores, -1.0), dim=-1,
                            keepdim=True)
        return (h_rad.gather(-1, best)[..., 0],
                torch.take_along_dim(h_cen, best[..., None], dim=-2)[..., 0, :])

    def basin_sigma(radius, center):
        """Tukey-weighted RMS residual at the fixed 0.5 * tol scale."""
        sres = dist(center) - radius[..., None]
        u_f = torch.clamp(torch.abs(sres) / (0.5 * tol_mm), max=1.0)
        w_f = (1.0 - u_f**2) ** 2
        sigma = torch.sqrt(torch.sum(w_f * sres**2, dim=-1)
                           / torch.clamp(w_f.sum(dim=-1), min=1.0))
        return torch.clamp(sigma, max=0.5 * tol_mm)

    # noise-adaptive selection: round A's raw best hypothesis measures the
    # surface's basin noise; round B scores and refines at scales widened
    # to it (equal to round A's on clean surfaces)
    sigma_a = basin_sigma(*pick_best(0.35 * tol_mm))
    score_b = torch.clamp(4.5 * sigma_a, min=0.35 * tol_mm)
    irls_b = torch.clamp(4.5 * sigma_a, min=0.5 * tol_mm)
    radius, center = pick_best(score_b)
    for _ in range(iters):
        resid = torch.abs(dist(center) - radius[..., None])
        u = torch.clamp(resid / irls_b[..., None], max=1.0)
        w_new = (1.0 - u**2) ** 2
        w_new = torch.where(w_new.sum(dim=-1, keepdim=True) < 32, w_heur,
                            w_new)
        radius, center = fit(w_new)
    sres = dist(center) - radius[..., None]
    sigma = basin_sigma(radius, center)
    resid = torch.abs(sres)

    neg_thr = torch.clamp(3.0 * sigma, min=0.4 * tol_mm)[..., None, None]
    pos_thr = torch.clamp(4.5 * sigma, min=1.25 * tol_mm)[..., None, None]
    in_thr = torch.clamp(3.0 * sigma, min=0.6 * tol_mm)[..., None]

    # rim cut: the articular surface ends where the surface first leaves
    # the sphere shell going distally (two consecutive rows must agree)
    sres2 = sres.reshape(lead + (r, c))
    leave = (sres2 < -neg_thr) | (sres2 > pos_thr)
    leave = leave & torch.cat(
        [leave[..., 1:, :],
         torch.zeros(lead + (1, c), dtype=torch.bool, device=dev)], dim=-2)
    first_leave = torch.where(leave.any(dim=-2),
                              torch.argmax(leave.to(torch.int8), dim=-2), r)
    above_rim = (torch.arange(r, device=dev)[:, None]
                 < first_leave[..., None, :]).reshape(lead + (r * c,))

    inlier = (resid < in_thr) & above_rim
    if support_mask is not None:
        strict = _longest_cyclic_run_per_row(
            inlier.reshape(lead + (r, c))).reshape(lead + (r * c,))
        sup = support_mask.reshape(lead + (r * c,)) > 0.5
        disagree = ((sup & ~strict).sum(dim=-1)
                    / torch.clamp(sup.sum(dim=-1), min=1))
        recall = ((sup & strict).sum(dim=-1)
                  / torch.clamp(strict.sum(dim=-1), min=1))
        strict_frac = strict.sum(dim=-1) / strict.shape[-1]
        plausible = ((disagree < support_max_disagree)
                     & (recall > support_min_recall))
        rescue = strict_frac < support_rescue_max_frac
        engage = (disagree > support_min_disagree) & (plausible | rescue)
        inlier = strict | (engage[..., None] & sup
                           & (resid < support_tol_factor * tol_mm))
    mask = _longest_cyclic_run_per_row(inlier.reshape(lead + (r, c)))
    mask_flat = mask.reshape(lead + (r * c,))
    mean_resid = (torch.where(mask_flat, resid, 0.0).sum(dim=-1)
                  / torch.clamp(mask_flat.sum(dim=-1), min=1))
    return mask.to(points.dtype), radius, center, mean_resid
