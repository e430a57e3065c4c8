"""The sphere segmenter's passes over the polar points
(models/segment.py through ops/sphere.py): the hypotheses' Tukey scores
and the fits' moments, each input read once and each output written
once (chip_smoke.py's sphere_work).  A (point, hypothesis) pair of the
score takes 18 float32 operations; a point of a fit 8 for the first
pass's sums and 35 for the centred moments, 16 more where its Tukey
weight is made (an IRLS pass); the basin sigma's pass 20 a point."""

HOOKS = (("ops.sphere", "scores"), ("ops.sphere", "fit_moments"),
         ("ops.sphere", "irls_moments"), ("ops.sphere", "sigma_sums"))
PRECISION = "fp32"
RANGES = ("sphere_segment",)
KERNELS = ("sphere_score_kernel", "sphere_fit_kernel", "sphere_sigma_kernel")
PER_POINT = {"given": 8 + 35, "tukey": 16 + 8 + 35, "sigma": 20}


def sphere_work(kind, n_bones, n_points, n_hyp=0, w_vectors=0):
    """(bytes, float32 operations) of one pass.  `w_vectors`: the given
    weight vectors of P (1 where one vector serves every bone)."""
    pts = 12 * n_bones * n_points
    if kind == "score":
        n_bytes = (pts + 4 * n_points + 16 * n_bones * n_hyp + 4 * n_bones
                   + 4 * n_bones * n_hyp)
        return n_bytes, 18 * n_bones * n_hyp * n_points
    outs = 4 * n_bones * (2 if kind == "sigma" else 3 + 20)
    ins = 4 * n_points * w_vectors if kind == "given" else 20 * n_bones
    return pts + ins + outs, PER_POINT[kind] * n_bones * n_points


def work(fn, args, kwargs, result):
    pts = args[0]
    n_bones = pts.numel() // (pts.shape[-1] * pts.shape[-2])
    n_points = pts.shape[-2]
    if fn == "scores":
        return sphere_work("score", n_bones, n_points,
                           n_hyp=args[2].shape[-1])
    if fn == "fit_moments":
        w = args[1]
        shared = w.dim() == 1 or all(s == 0 for s in w.stride()[:-1])
        return sphere_work("given", n_bones, n_points,
                           w_vectors=1 if shared else n_bones)
    if fn == "irls_moments":
        return sphere_work("tukey", n_bones, n_points)
    return sphere_work("sigma", n_bones, n_points)
