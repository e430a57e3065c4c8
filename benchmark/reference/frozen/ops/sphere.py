"""The sphere segmenter's passes over the points (models/segment.py,
`sphere_segment`): the row-weighted Tukey score of every hypothesis, and
the weighted sphere moments of each fit, with the IRLS and basin-sigma
Tukey weights made inside the pass.

On CPU tensors each wrapper runs its plain PyTorch version, the
segmenter's own code as it was written before the kernels, so a CPU
segmentation is bit for bit what it was.  On CUDA tensors it launches
its kernel from the port's library (ops/kernels.py) or raises:
csrc/sphere_score.cu (`sphere_score_kernel`, one launch per pick) and
csrc/sphere_fit.cu (`sphere_fit_kernel`, two launches per fit, one per
basin sigma).  `score_launch_count` and `fit_launch_count` count the
launches.

Each kernel sums in one fixed order that depends on the number of points
alone (no float atomics), so a bone's results do not depend on the batch
it runs in.  The kernels' numerics contract is at the top of each .cu
file.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.frozen.utils import fits


# the weights of a fit pass (csrc/sphere_fit.cu): given, the IRLS Tukey
# weights from a sphere, or the basin sigma's
GIVEN, TUKEY, SIGMA = 0, 1, 2
# the plain score's hypotheses at a time: its largest intermediate is
# (bones, HYP_CHUNK, points, 3) float32, 100 MB per bone at DEFAULT_CONFIG's
# 262,144 points, where all 130 at once would take 409 MB per bone
HYP_CHUNK = 32
# bones a launch takes: the grid's y dimension
MAX_BONES = 65535
# an IRLS pass whose Tukey weights sum below this takes the top-rows fit
MIN_WEIGHT = 32



# ---- plain versions --------------------------------------------------------

def distance(pts, center):
    """Distance of every point (..., P, 3) to each bone's center (..., 3):
    (..., P)."""
    return torch.linalg.vector_norm(pts - center[..., None, :], dim=-1)


def pickable(h_rad, h_cen):
    """The hypotheses a pick may take: finite, radius in (10, 45) mm."""
    return (torch.isfinite(h_rad) & torch.isfinite(h_cen).all(dim=-1)
            & (h_rad > 10.0) & (h_rad < 45.0))


def score_plain(pts, w_row, h_rad, h_cen, scale):
    """Row-weighted Tukey score (..., H) of the hypotheses h_rad (..., H),
    h_cen (..., H, 3) over the points (..., P, 3) at `scale` (a number or
    one per bone), HYP_CHUNK hypotheses at a time, so the point-to-center
    differences take (..., HYP_CHUNK, P, 3) and not (..., H, P, 3)."""
    if torch.is_tensor(scale):
        scale = scale[..., None, None]

    def score(rad, cen):
        d = torch.linalg.vector_norm(
            pts[..., None, :, :] - cen[..., :, None, :], dim=-1)
        resid = torch.abs(d - rad[..., None])                # (..., h, P)
        u = torch.clamp(resid / scale, max=1.0)
        return torch.sum(w_row * (1.0 - u**2) ** 2, dim=-1)

    return torch.cat([score(rad, cen) for rad, cen in zip(
        h_rad.split(HYP_CHUNK, dim=-1), h_cen.split(HYP_CHUNK, dim=-2))],
        dim=-1)


def moments_plain(pts, w):
    """The centred normal equations of the weighted sphere fit of each
    bone, w (..., P): (mean (..., 3), normal (..., 4, 5) = A^T W [A | f])
    with A = [2 q, 1], f = |q|^2, q = x - mean."""
    mean = (torch.sum(pts * w[..., None], dim=-2)
            / torch.clamp(w.sum(dim=-1), min=1)[..., None])
    q = pts - mean[..., None, :]
    ones = torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype,
                      device=pts.device)
    a = torch.cat([2.0 * q, ones], dim=-1)
    f = torch.sum(q**2, dim=-1)
    # A^T W [A | f] in one sum (as utils/fits.fit_sphere)
    normal = fits.gram(a * w[..., None], torch.cat([a, f[..., None]], dim=-1))
    return mean, normal


def solve(mean, normal, eye4):
    """The least-squares sphere (radius (...,), center (..., 3)) of each
    bone from its fit's centred normal equations (`moments_plain`), eye4
    the 4 x 4 identity.  The same PyTorch solve on every device."""
    sol = torch.linalg.solve_ex(normal[..., :4] + 1e-6 * eye4,
                                normal[..., 4]).result
    center = sol[..., :3] + mean
    radius = torch.sqrt(torch.clamp(
        sol[..., 3] + torch.sum(sol[..., :3] ** 2, dim=-1), min=1e-9))
    return radius, center


def tukey_plain(pts, radius, center, scale):
    """The IRLS weights (..., P): (1 - min(| |x - c| - r | / scale, 1)^2)^2,
    scale one per bone (...)."""
    resid = torch.abs(distance(pts, center) - radius[..., None])
    u = torch.clamp(resid / scale[..., None], max=1.0)
    return (1.0 - u**2) ** 2


def irls_moments_plain(pts, radius, center, scale, w_heur):
    """(mean, normal) of one IRLS pass: the Tukey weights at `scale` (one
    per bone) from the sphere (radius, center), or the top-rows weights
    w_heur for a bone whose weights sum below MIN_WEIGHT."""
    w_new = tukey_plain(pts, radius, center, scale)
    w_new = torch.where(w_new.sum(dim=-1, keepdim=True) < MIN_WEIGHT, w_heur,
                        w_new)
    return moments_plain(pts, w_new)


def sigma_sums_plain(pts, radius, center, scale: float):
    """(sum w, sum w sres^2) (...,) of the basin sigma: sres = |x - c| - r,
    w = (1 - min(|sres| / scale, 1)^2)^2."""
    sres = distance(pts, center) - radius[..., None]
    u_f = torch.clamp(torch.abs(sres) / scale, max=1.0)
    w_f = (1.0 - u_f**2) ** 2
    return w_f.sum(dim=-1), torch.sum(w_f * sres**2, dim=-1)


# ---- what sphere_segment calls ---------------------------------------------

def scores(pts, w_row, h_rad, h_cen, scale):
    """`score_plain` on CPU tensors, the score kernel on CUDA tensors."""
    return score_plain(pts, w_row, h_rad, h_cen, scale)


def fit_moments(pts, w):
    """(mean, normal) of the fit with weights w (..., P): `moments_plain`
    on CPU tensors, the fit kernel's two passes on CUDA tensors."""
    return moments_plain(pts, w)


def irls_moments(pts, radius, center, scale, w_heur, heur):
    """(mean, normal) of one IRLS pass: the Tukey weights at `scale` (one
    per bone) from the sphere (radius, center), except that a bone whose
    weights sum below MIN_WEIGHT takes the top-rows weights w_heur, whose
    moments are `heur` (fit_moments(pts, w_heur)).  CPU tensors take
    `irls_moments_plain`; CUDA tensors the fit kernel's passes with the
    weights made inside, and `heur` where the kernel's first pass sums the
    weights below MIN_WEIGHT, selected before the solve (the same moments
    the plain weights give there)."""
    return irls_moments_plain(pts, radius, center, scale, w_heur)


def sigma_sums(pts, radius, center, scale: float):
    """(sum w, sum w sres^2) of the basin sigma at `scale`:
    `sigma_sums_plain` on CPU tensors, the fit kernel's sigma pass on CUDA
    tensors."""
    return sigma_sums_plain(pts, radius, center, scale)


# ---- the kernels -----------------------------------------------------------
