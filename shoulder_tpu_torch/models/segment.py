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

import torch

from shoulder_tpu_torch.utils import jax_prng

N_HYP = 128


def ransac_indices(top_n: int, device, seed: int = 17):
    """(N_HYP, 4) int64 RANSAC quadruples in [0, top_n): the JAX package's
    draw `jax.random.randint(PRNGKey(seed), (128, 4), 0, top_n)`, made on
    the host and copied to `device`."""
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
      points: (R, C, 3) surface points in the OBB frame, row 0 the most
        proximal slice.
      hyp_idx: (128, 4) int indices into the first int(0.4 R) * C points,
        the RANSAC quadruples (see the module note).
      iters: IRLS iterations after the hypothesis pick.
      tol_mm: base tolerance in mm; strict inliers use 0.6x this.
      init_top_rows: fraction of top rows seeding the least-squares
        hypothesis.
      init_mask: optional (R, C) {0,1} seed (the UNet mask) that competes
        as one more hypothesis.
      support_mask: optional (R, C) {0,1} CNN evidence that may widen the
        final mask up to support_tol_factor * tol_mm from the sphere, when
        the gate (min/max disagree, min recall, or the rescue below
        support_rescue_max_frac of the image) lets it.

    Returns (mask (R, C) float {0,1}, radius, center, mean_resid).
    """
    r, c = points.shape[0], points.shape[1]
    pts = points.reshape(-1, 3)
    dt, dev = pts.dtype, pts.device
    eye4 = torch.eye(4, dtype=dt, device=dev)
    ones = torch.ones((pts.shape[0], 1), dtype=dt, device=dev)

    def fit(w):
        mean = torch.sum(pts * w[:, None], dim=0) / torch.clamp(w.sum(), min=1)
        q = pts - mean
        a = torch.cat([2.0 * q, ones], dim=1)
        f = torch.sum(q**2, dim=1)
        aw = a * w[:, None]
        sol = torch.linalg.solve_ex(aw.T @ a + 1e-6 * eye4, aw.T @ f).result
        center = sol[:3] + mean
        radius = torch.sqrt(torch.clamp(sol[3] + torch.sum(sol[:3] ** 2),
                                        min=1e-9))
        return radius, center

    # selection-only row prior: scores decay to 0.2x over rows 0.45R..0.75R
    row_of = torch.arange(r, device=dev).repeat_interleave(c)
    t_row = torch.clamp((row_of.to(dt) - 0.45 * r) / (0.30 * r), 0.0, 1.0)
    w_row = 1.0 - 0.8 * t_row * t_row * (3.0 - 2.0 * t_row)

    # RANSAC: minimal 4-point sphere hypotheses from the top rows
    quads = pts[hyp_idx]                                   # (H, 4, 3)
    a4 = torch.cat([2.0 * quads, torch.ones((quads.shape[0], 4, 1),
                                            dtype=dt, device=dev)], dim=2)
    f4 = torch.sum(quads**2, dim=2)
    sol = torch.linalg.solve_ex(a4, f4).result
    h_cen = sol[:, :3]
    h_rad = torch.sqrt(torch.clamp(sol[:, 3] + torch.sum(h_cen**2, dim=1),
                                   min=1e-9))
    # the top-rows least squares and the CNN proposal compete as two more
    w_heur = (row_of < int(init_top_rows * r)).to(dt)
    extra = [fit(w_heur)]
    if init_mask is not None:
        w_seed = init_mask.reshape(-1).to(dt)
        w_seed = torch.where(w_seed.sum() < 32, w_heur, w_seed)
        extra.append(fit(w_seed))
    h_rad = torch.cat([h_rad, torch.stack([e[0] for e in extra])])
    h_cen = torch.cat([h_cen, torch.stack([e[1] for e in extra])])

    def dist(center):
        return torch.linalg.vector_norm(pts - center, dim=-1)

    def pick_best(score_scale):
        """Best hypothesis under the row-weighted Tukey score."""
        ok = (torch.isfinite(h_rad) & torch.isfinite(h_cen).all(dim=1)
              & (h_rad > 10.0) & (h_rad < 45.0))
        resid = torch.abs(dist(h_cen[:, None, :]) - h_rad[:, None])
        u = torch.clamp(resid / score_scale, max=1.0)
        scores = torch.sum(w_row * (1.0 - u**2) ** 2, dim=1)
        best = torch.argmax(torch.where(ok, scores, -1.0)).view(1)
        return h_rad.index_select(0, best)[0], h_cen.index_select(0, best)[0]

    def basin_sigma(radius, center):
        """Tukey-weighted RMS residual at the fixed 0.5 * tol scale."""
        sres = dist(center) - radius
        u_f = torch.clamp(torch.abs(sres) / (0.5 * tol_mm), max=1.0)
        w_f = (1.0 - u_f**2) ** 2
        sigma = torch.sqrt(torch.sum(w_f * sres**2)
                           / torch.clamp(w_f.sum(), min=1.0))
        return torch.clamp(sigma, max=0.5 * tol_mm)

    # noise-adaptive selection: round A's raw best hypothesis measures the
    # surface's basin noise; round B scores and refines at scales widened
    # to it (equal to round A's on clean surfaces)
    sigma_a = basin_sigma(*pick_best(0.35 * tol_mm))
    score_b = torch.clamp(4.5 * sigma_a, min=0.35 * tol_mm)
    irls_b = torch.clamp(4.5 * sigma_a, min=0.5 * tol_mm)
    radius, center = pick_best(score_b)
    for _ in range(iters):
        resid = torch.abs(dist(center) - radius)
        u = torch.clamp(resid / irls_b, max=1.0)
        w_new = (1.0 - u**2) ** 2
        w_new = torch.where(w_new.sum() < 32, w_heur, w_new)
        radius, center = fit(w_new)
    sres = dist(center) - radius
    sigma = basin_sigma(radius, center)
    resid = torch.abs(sres)

    neg_thr = torch.clamp(3.0 * sigma, min=0.4 * tol_mm)
    pos_thr = torch.clamp(4.5 * sigma, min=1.25 * tol_mm)
    in_thr = torch.clamp(3.0 * sigma, min=0.6 * tol_mm)

    # rim cut: the articular surface ends where the surface first leaves
    # the sphere shell going distally (two consecutive rows must agree)
    sres2 = sres.reshape(r, c)
    leave = (sres2 < -neg_thr) | (sres2 > pos_thr)
    leave = leave & torch.cat(
        [leave[1:], torch.zeros((1, c), dtype=torch.bool, device=dev)], dim=0)
    first_leave = torch.where(leave.any(dim=0),
                              torch.argmax(leave.to(torch.int8), dim=0), r)
    above_rim = (torch.arange(r, device=dev)[:, None]
                 < first_leave[None, :]).reshape(-1)

    inlier = (resid < in_thr) & above_rim
    if support_mask is not None:
        strict = _longest_cyclic_run_per_row(inlier.reshape(r, c)).reshape(-1)
        sup = support_mask.reshape(-1) > 0.5
        disagree = (sup & ~strict).sum() / torch.clamp(sup.sum(), min=1)
        recall = (sup & strict).sum() / torch.clamp(strict.sum(), min=1)
        strict_frac = strict.sum() / strict.shape[0]
        plausible = ((disagree < support_max_disagree)
                     & (recall > support_min_recall))
        rescue = strict_frac < support_rescue_max_frac
        engage = (disagree > support_min_disagree) & (plausible | rescue)
        inlier = strict | (engage & sup
                           & (resid < support_tol_factor * tol_mm))
    mask = _longest_cyclic_run_per_row(inlier.reshape(r, c))
    mean_resid = (torch.where(mask.reshape(-1), resid, 0.0).sum()
                  / torch.clamp(mask.sum(), min=1))
    return mask.to(points.dtype), radius, center, mean_resid
