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
basin sigma).  The recorder's counters `launches.sphere_score` and
`launches.sphere_fit` (utils/trace.py) count the launches.

Each kernel sums in one fixed order that depends on the number of points
alone (no float atomics), so a bone's results do not depend on the batch
it runs in.  The kernels' numerics contract is at the top of each .cu
file.
"""

from __future__ import annotations

import math

import torch

from shoulder_tpu_torch.ops import kernels
from shoulder_tpu_torch.utils import fits, trace

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

# per device: (B,) tile counters the kernels leave at 0 (csrc/*.cu)
_counters: dict[str, torch.Tensor] = {}


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
    if pts.device.type == "cpu":
        return score_plain(pts, w_row, h_rad, h_cen, scale)
    return sphere_score_kernel(pts, w_row, h_rad.contiguous(),
                               h_cen.contiguous(), scale)


def fit_moments(pts, w):
    """(mean, normal) of the fit with weights w (..., P): `moments_plain`
    on CPU tensors, the fit kernel's two passes on CUDA tensors."""
    if pts.device.type == "cpu":
        return moments_plain(pts, w)
    _, mean, normal = sphere_fit_kernel(pts, GIVEN, w=w)
    return mean, normal


def irls_moments(pts, radius, center, scale, w_heur, heur):
    """(mean, normal) of one IRLS pass: the Tukey weights at `scale` (one
    per bone) from the sphere (radius, center), except that a bone whose
    weights sum below MIN_WEIGHT takes the top-rows weights w_heur, whose
    moments are `heur` (fit_moments(pts, w_heur)).  CPU tensors take
    `irls_moments_plain`; CUDA tensors the fit kernel's passes with the
    weights made inside, and `heur` where the kernel's first pass sums the
    weights below MIN_WEIGHT, selected before the solve (the same moments
    the plain weights give there)."""
    if pts.device.type == "cpu":
        return irls_moments_plain(pts, radius, center, scale, w_heur)
    sums, mean, normal = sphere_fit_kernel(
        pts, TUKEY, radius=radius.contiguous(), center=center.contiguous(),
        scale=scale.contiguous())
    low = sums[..., 0] < MIN_WEIGHT
    return (torch.where(low[..., None], heur[0], mean),
            torch.where(low[..., None, None], heur[1], normal))


def sigma_sums(pts, radius, center, scale: float):
    """(sum w, sum w sres^2) of the basin sigma at `scale`:
    `sigma_sums_plain` on CPU tensors, the fit kernel's sigma pass on CUDA
    tensors."""
    if pts.device.type == "cpu":
        return sigma_sums_plain(pts, radius, center, scale)
    sums, _, _ = sphere_fit_kernel(pts, SIGMA, radius=radius.contiguous(),
                                   center=center.contiguous(), scale=scale)
    return sums[..., 0], sums[..., 4]


# ---- the kernels -----------------------------------------------------------

def _check(name, t, shape, dev):
    if (not torch.is_tensor(t) or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"float32 tensor on {dev}")


def _check_points(pts):
    if pts.dim() < 2 or pts.shape[-1] != 3 or pts.shape[-2] < 1:
        raise ValueError(f"points must be (..., P, 3) with P >= 1, not "
                         f"{tuple(pts.shape)}")
    _check("points", pts, pts.shape, pts.device)
    n_bones = math.prod(pts.shape[:-2])
    if n_bones > MAX_BONES:
        raise ValueError(f"{n_bones} bones above the kernels' {MAX_BONES}")
    return pts.shape[:-2], pts.shape[-2], n_bones


def _check_cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"the sphere kernels run on CUDA tensors, not {dev}")


def _scale(scale, lead, dev):
    """(pointer or None, value) of a scale: one per bone or one number."""
    if torch.is_tensor(scale):
        _check("scale", scale, lead, dev)
        return scale.data_ptr(), 0.0
    return None, float(scale)


def _done(dev, n_bones):
    """The device's tile counters, at least n_bones of them (0 between
    launches: each kernel's last block of a bone resets its own)."""
    key = str(dev)
    done = _counters.get(key)
    if done is None or done.numel() < n_bones:
        done = torch.zeros(max(n_bones, 64), dtype=torch.int32, device=dev)
        _counters[key] = done
    return done


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def sphere_score_kernel(pts, w_row, h_rad, h_cen, scale, lib=None):
    """One launch of csrc/sphere_score.cu: the row-weighted Tukey score
    (..., H) of every hypothesis of every bone, what `score_plain` returns
    (CUDA tensors: pts (..., P, 3), w_row (P,), h_rad (..., H), h_cen (...,
    H, 3), scale a number or (...,)).  Raises on arguments the kernel does
    not take, on a failed build and on a refused launch."""
    lead, n_points, n_bones = _check_points(pts)
    dev = pts.device
    _check("w_row", w_row, (n_points,), dev)
    if h_rad.dim() != len(lead) + 1:
        raise ValueError(f"h_rad must be (..., H), not {tuple(h_rad.shape)}")
    n_hyp = h_rad.shape[-1]
    _check("h_rad", h_rad, lead + (n_hyp,), dev)
    _check("h_cen", h_cen, lead + (n_hyp, 3), dev)
    scale_ptr, scale_value = _scale(scale, lead, dev)
    _check_cuda(dev)
    lib = lib or kernels.library()
    if n_hyp > lib.sphere_score_max_hyp():
        raise ValueError(f"{n_hyp} hypotheses above the kernel's "
                         f"{lib.sphere_score_max_hyp()}")
    tiles = -(-n_points // lib.sphere_score_tile())
    out = torch.empty(lead + (n_hyp,), dtype=torch.float32, device=dev)
    partial = torch.empty((n_bones, tiles, n_hyp), dtype=torch.float32,
                          device=dev)
    rc = lib.sphere_score_launch(
        pts.data_ptr(), w_row.data_ptr(), h_rad.data_ptr(), h_cen.data_ptr(),
        scale_ptr, scale_value, partial.data_ptr(),
        _done(dev, n_bones).data_ptr(), out.data_ptr(), n_points, n_bones,
        n_hyp, dev.index or 0, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sphere_score kernel launch failed: CUDA error "
                           f"{rc}")
    if n_bones and n_hyp:  # nothing to score, no launch
        trace.count("launches.sphere_score")
    return out


def sphere_fit_kernel(pts, weights, w=None, radius=None, center=None,
                      scale=None, lib=None):
    """The passes of csrc/sphere_fit.cu over the points (..., P, 3) (CUDA
    tensors), with `weights` GIVEN (w (..., P), contiguous or one (P,)
    vector expanded over the bones), TUKEY or SIGMA (from radius (...,),
    center (..., 3) and scale, a number or (...,)).  Returns (sums (...,
    5) = [sum w, sum w x, sum w y, sum w z, sum w sres^2], mean (..., 3),
    normal (..., 4, 5)): GIVEN and TUKEY launch both passes, what
    `moments_plain` returns as (mean, normal); SIGMA launches the first
    alone (mean and normal None; sums [0] and [4] are `sigma_sums_plain`).
    Raises on arguments the kernel does not take, on a failed build and
    on a refused launch."""
    lead, n_points, n_bones = _check_points(pts)
    dev = pts.device
    f32 = dict(dtype=torch.float32, device=dev)
    w_ptr, w_stride = None, 0
    c_ptr = r_ptr = scale_ptr = None
    scale_value = 0.0
    if weights == GIVEN:
        if (not torch.is_tensor(w) or w.dtype != torch.float32
                or tuple(w.shape) != lead + (n_points,) or w.device != dev
                or w.stride(-1) != 1):
            raise ValueError(f"w must be a {lead + (n_points,)} float32 "
                             f"tensor on {dev}")
        if w.is_contiguous():
            w_stride = n_points
        elif not all(s == 0 for s in w.stride()[:-1]):
            raise ValueError("w must be contiguous or one vector expanded "
                             "over the bones")
        w_ptr = w.data_ptr()
    elif weights in (TUKEY, SIGMA):
        _check("radius", radius, lead, dev)
        _check("center", center, lead + (3,), dev)
        c_ptr, r_ptr = center.data_ptr(), radius.data_ptr()
        scale_ptr, scale_value = _scale(scale, lead, dev)
    else:
        raise ValueError(f"weights {weights} not one of GIVEN, TUKEY, SIGMA")
    _check_cuda(dev)
    lib = lib or kernels.library()
    tiles = -(-n_points // lib.sphere_fit_tile())
    partial = torch.empty((n_bones, tiles, lib.sphere_fit_partials()), **f32)
    sums = torch.empty(lead + (5,), **f32)
    mean = normal = None
    passes = (1,) if weights == SIGMA else (1, 2)
    if weights != SIGMA:
        mean = torch.empty(lead + (3,), **f32)
        normal = torch.empty(lead + (4, 5), **f32)
    done = _done(dev, n_bones)
    for n_pass in passes:
        rc = lib.sphere_fit_launch(
            pts.data_ptr(), w_ptr, w_stride, c_ptr, r_ptr, scale_ptr,
            scale_value, n_pass, weights, partial.data_ptr(),
            done.data_ptr(), sums.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if normal is None else normal.data_ptr(), n_points,
            n_bones, dev.index or 0, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"sphere_fit kernel launch (pass {n_pass}) "
                               f"failed: CUDA error {rc}")
        if n_bones:  # no bones, no launch
            trace.count("launches.sphere_fit")
    return sums, mean, normal
