"""1D signal ops (PyTorch): Savitzky-Golay, find_peaks, linear-kernel KDE,
RBF changepoint, monotone-source row selection and ascending interp.

Port of the functions of shoulder_tpu/ops/signal.py that the landmark
pipeline runs.  Row-wise ops take an explicit leading row dimension where
the JAX package vmapped them (a bone batch folds into it), and the
per-signal ops (the KDE, the changepoint) take leading batch dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_BIG = torch.inf


def savgol_filter(x, window: int, polyorder: int):
    """scipy.signal.savgol_filter(mode='interp') along the last axis, for
    polyorder 1: a moving average inside, a linear fit over the first and
    last `window` samples at the edges."""
    if polyorder != 1:
        raise NotImplementedError("only polyorder=1 is used by the pipeline")
    n = x.shape[-1]
    dev = x.device
    half_lo = (window - 1) // 2
    half_hi = window - 1 - half_lo
    edge = window // 2

    c = torch.cumsum(
        torch.cat([torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype,
                               device=dev), x], dim=-1),
        dim=-1,
    )
    idx = torch.arange(n, device=dev)
    lo = torch.clamp(idx - half_lo, 0, n)
    hi = torch.clamp(idx + half_hi + 1, 0, n)
    interior = (c[..., hi] - c[..., lo]) / window

    w_start, w_end = _savgol_edges(window, str(dev))
    head = torch.einsum("ew,...w->...e", w_start.to(x.dtype), x[..., :window])
    tail = torch.einsum("ew,...w->...e", w_end.to(x.dtype), x[..., -window:])
    return torch.cat([head, interior[..., edge:n - edge], tail], dim=-1)


@functools.lru_cache(maxsize=None)
def _savgol_edges(window: int, device: str):
    """The linear fits' weights over the first and last `window // 2`
    samples, float32 on `device`: copied there once per (window, device)
    per process (the copy waits for the device); shared, never written."""
    edge = window // 2
    t = np.arange(window)
    a = np.stack([t, np.ones(window)], axis=1)
    proj = np.linalg.pinv(a)
    return tuple(torch.as_tensor(w.astype(np.float32), device=device)
                 for w in (a[:edge] @ proj, a[window - edge:] @ proj))


def _peaks_core_dense_cand(x, height: float, prominence: float, width: float,
                           cand_cap: int | None = None):
    """find_peaks core on rows x (S, n) via dense (S, C, n) masks over the
    compacted local maxima, in candidate space (ascending position).

    Returns (cand, cvalid, ok_c, prom_c, widths_c, wh_c, overflow): overflow
    (S,) is true where a row had more local maxima than the C = cand_cap
    slots (default n // 2 + 1, which holds every possible maximum); maxima
    past the cap are dropped positionally.
    """
    n_rows, n = x.shape
    dev, dt = x.device, x.dtype
    i = torch.arange(n, device=dev)
    inf_col = torch.full((n_rows, 1), _BIG, dtype=dt, device=dev)
    left = torch.cat([inf_col, x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], inf_col], dim=1)
    is_peak = (x > left) & (x > right) & (x >= height)

    c = min(n // 2 + 1 if cand_cap is None else cand_cap, n)
    csum = torch.cumsum(is_peak.to(torch.int64), dim=1)
    dest = torch.where(is_peak & (csum - 1 < c), csum - 1, c)
    cand = torch.zeros((n_rows, c + 1), dtype=torch.int64, device=dev)
    cand.scatter_(1, dest, i.expand(n_rows, n))
    cand = cand[:, :c]
    cvalid = torch.arange(c, device=dev) < csum[:, -1:]
    overflow = csum[:, -1] > c

    xc = x.gather(1, cand)                        # (S, C)
    xp = xc[:, :, None]
    xj = x[:, None, :]
    jj = i[None, None, :]
    pp = cand[:, :, None]

    greater = xj > xp
    lb_bound = torch.where(greater & (jj < pp), jj, -1).amax(dim=2)
    rb_bound = torch.where(greater & (jj > pp), jj, n).amin(dim=2)

    # left interval (lb_bound, p]: min value, base = largest argmin (ties
    # toward the peak, as scipy's walk); the right interval mirrored
    lvals = torch.where((jj > lb_bound[..., None]) & (jj <= pp), xj, _BIG)
    lmin = lvals.amin(dim=2)
    lbase = torch.where(lvals == lmin[..., None], jj, -1).amax(dim=2)
    rvals = torch.where((jj < rb_bound[..., None]) & (jj >= pp), xj, _BIG)
    rmin = rvals.amin(dim=2)
    rbase = torch.where(rvals == rmin[..., None], jj, n).amin(dim=2)

    prom_c = xc - torch.maximum(lmin, rmin)
    wh_c = xc - 0.5 * prom_c                      # rel_height 0.5
    whc = wh_c[..., None]
    # left crossing: largest j in [lbase, p] with x[j] <= wh
    lj = torch.where((jj >= lbase[..., None]) & (jj <= pp) & (xj <= whc),
                     jj, -1).amax(dim=2)
    lj = torch.clamp(lj, 0, n - 1)
    x_lj = x.gather(1, lj)
    x_ljn = x.gather(1, torch.clamp(lj + 1, max=n - 1))
    denom_l = x_ljn - x_lj
    frac_l = torch.where(
        (x_lj < wh_c) & (torch.abs(denom_l) > 0),
        (wh_c - x_lj) / torch.where(denom_l == 0, 1.0, denom_l),
        0.0,
    )
    left_ip = torch.where(x_lj < wh_c, lj + frac_l, lj.to(dt))
    # right crossing: smallest j in [p, rbase] with x[j] <= wh
    rj = torch.where((jj <= rbase[..., None]) & (jj >= pp) & (xj <= whc),
                     jj, n).amin(dim=2)
    rj = torch.clamp(rj, 0, n - 1)
    x_rj = x.gather(1, rj)
    x_rjp = x.gather(1, torch.clamp(rj - 1, min=0))
    denom_r = x_rjp - x_rj
    frac_r = torch.where(
        (x_rj < wh_c) & (torch.abs(denom_r) > 0),
        (wh_c - x_rj) / torch.where(denom_r == 0, 1.0, denom_r),
        0.0,
    )
    right_ip = torch.where(x_rj < wh_c, rj - frac_r, rj.to(dt))

    widths_c = right_ip - left_ip
    ok_c = cvalid & (prom_c >= prominence) & (widths_c >= width)
    return cand, cvalid, ok_c, prom_c, widths_c, wh_c, overflow


def find_peaks(x, height: float, prominence: float, width: float,
               max_peaks: int = 16, cand_cap: int | None = None):
    """scipy.signal.find_peaks(height=, prominence=, width=) on rows x (S, n).

    Returns a dict of (S, max_peaks) arrays sorted by descending
    prominence, `valid` marking real peaks: idx, prominences, widths,
    width_heights, valid; and (S,) n_peaks and overflow (see
    `_peaks_core_dense_cand`; callers that pass a cap must surface it).
    """
    cand, cvalid, ok_c, prom_c, widths_c, wh_c, overflow = (
        _peaks_core_dense_cand(x, height, prominence, width, cand_cap)
    )
    ok_c = ok_c & cvalid
    c = cand.shape[1]
    if c < max_peaks:  # tiny inputs: pad candidate slots to max_peaks
        pad = (0, max_peaks - c)
        cand = torch.nn.functional.pad(cand, pad)
        ok_c = torch.nn.functional.pad(ok_c, pad)
        prom_c = torch.nn.functional.pad(prom_c, pad)
        widths_c = torch.nn.functional.pad(widths_c, pad)
        wh_c = torch.nn.functional.pad(wh_c, pad)
    score = torch.where(ok_c, prom_c, -_BIG)
    order = torch.argsort(-score, dim=1, stable=True)[:, :max_peaks]
    valid = ok_c.gather(1, order)
    return {
        "idx": torch.where(valid, cand.gather(1, order), 0),
        "prominences": torch.where(valid, prom_c.gather(1, order), 0.0),
        "widths": torch.where(valid, widths_c.gather(1, order), 0.0),
        "width_heights": torch.where(valid, wh_c.gather(1, order), 0.0),
        "valid": valid,
        "n_peaks": ok_c.sum(dim=1),
        "overflow": overflow,
    }


def kde_linear_argmax(samples, sample_weights, grid):
    """argmax over `grid` (G,) of a linear-kernel KDE (bandwidth 1.0):
    density proportional to sum_i w_i max(0, 1 - |x - x_i|), for samples
    and weights (..., n).  Returns (argmax (...,), density (..., G)); the
    argmax is gathered on the device, with no host read."""
    d = torch.abs(grid[:, None] - samples[..., None, :])
    k = torch.clamp(1.0 - d, min=0.0) * sample_weights[..., None, :]
    dens = k.sum(dim=-1)
    best = torch.argmax(dens, dim=-1)
    return grid.index_select(0, best.reshape(-1)).reshape(best.shape), dens


def rbf_changepoint_1bkp(signal, min_size: int = 2):
    """Exact single-breakpoint RBF-kernel changepoint
    (ruptures.KernelCPD(kernel='rbf').predict(n_bkps=1)): gamma = 1 /
    median off-diagonal squared distance; cost c(s,e) = (e-s) - S(s,e)/(e-s)
    with S the Gram-block sum; argmin over t of c(0,t) + c(t,n).  Signals
    (..., n) give breakpoints (...,)."""
    x = signal.to(torch.float32)
    n = x.shape[-1]
    lead = x.shape[:-1]
    dev = x.device
    d2 = (x[..., :, None] - x[..., None, :]) ** 2
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    m = n * (n - 1)
    srt = torch.sort(torch.where(off, d2, torch.inf).reshape(lead + (-1,)),
                     dim=-1).values
    med = 0.5 * (srt[..., (m - 1) // 2] + srt[..., m // 2])
    med = torch.where(med > 0, med, 1.0)
    k = torch.exp(-d2 / med[..., None, None]) * off + torch.eye(n, device=dev)

    csum = torch.cumsum(torch.cumsum(k, dim=-2), dim=-1)
    padded = torch.zeros(lead + (n + 1, n + 1), device=dev)
    padded[..., 1:, 1:] = csum
    ts = torch.arange(n, device=dev)
    len1 = ts.to(torch.float32)
    len2 = (n - ts).to(torch.float32)
    diag = torch.diagonal(padded, dim1=-2, dim2=-1)[..., :n]
    s1 = (diag - padded[..., 0, :n] - padded[..., :n, 0]
          + padded[..., 0, :1])                                 # block(0, t)
    s2 = (padded[..., n, n:] - padded[..., :n, n] - padded[..., n, :n]
          + diag)                                               # block(t, n)
    cost = (len1 - s1 / torch.clamp(len1, min=1.0)
            + len2 - s2 / torch.clamp(len2, min=1.0))
    ok = (ts >= min_size) & (ts <= n - min_size)
    return torch.argmin(torch.where(ok, cost, torch.inf), dim=-1)


def fill_from_scatter(dest, rows, m: int, init_row):
    """`out[b, j] = rows[b, max{k : 0 <= dest[b, k] <= j}]`, `init_row[b]`
    where that set is empty: monotone-source row selection.

    dest (B, n) int, rows (B, n, C), init_row (B, C) -> (B, m, C).  Holds
    for ARBITRARY dest (the JAX package's dense=True semantics): the rank
    is a scatter-max of k at slot dest[k] (entries outside [0, m) dropped)
    followed by a running max.
    """
    n_b, n = dest.shape
    dev = dest.device
    slot = torch.where((dest >= 0) & (dest < m), dest, m)
    rank = torch.full((n_b, m + 1), -1, dtype=torch.int64, device=dev)
    rank.scatter_reduce_(1, slot, torch.arange(n, device=dev).expand(n_b, n),
                         reduce="amax")
    rank = torch.cummax(rank[:, :m], dim=1).values
    padded = torch.cat([init_row[:, None, :], rows], dim=1)
    return padded.gather(1, (rank + 1)[..., None].expand(-1, -1, rows.shape[2]))


def interp_ascending(x, xp, fp, grid):
    """Row-wise `numpy.interp(x, xp, fp)` for ascending queries on a
    uniform grid.

    x (R, m) must equal `x0 + j * step` exactly for grid = (x0 (R,),
    step (R,)): each knot's first covering query then comes from the grid
    inverse with a +-1 correction, and no per-query binary search runs.
    xp (R, n) ascending, fp (R, n).
    """
    m, n = x.shape[1], xp.shape[1]
    x0, dt = grid
    x0, dt = x0[:, None], dt[:, None]
    uniform = dt > 0.0
    est = torch.ceil((xp - x0) / torch.where(uniform, dt, 1.0))
    est = torch.clamp(est, 0.0, float(m)).to(torch.int64)
    est = torch.where(uniform, est, torch.where(xp <= x0, 0, m))
    ef = est.to(x.dtype)
    g2_lo = x0 + (ef - 1.0) * dt
    g2_hi = torch.where(est >= m, torch.inf, x0 + ef * dt)
    lo_ok = (est >= 1) & (g2_lo >= xp)
    hi_bad = g2_hi < xp
    b = torch.where(lo_ok, est - 1, torch.where(hi_bad, est + 1, est))

    table = torch.stack([xp, fp], dim=2)
    left = torch.cat([table[:, : n - 1], table[:, n - 2: n - 1]], dim=1)
    right = torch.cat([table[:, 1:], table[:, n - 1:]], dim=1)
    src_rows = torch.cat([left, right], dim=2)          # (R, n, 4)
    g = fill_from_scatter(b, src_rows, m, src_rows[:, 0])
    g0, g1 = g[..., 0:2], g[..., 2:4]
    df = g1[..., 1] - g0[..., 1]
    dx = g1[..., 0] - g0[..., 0]
    delta = x - g0[..., 0]
    epsilon = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, g0[..., 1],
                    g0[..., 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    f = torch.where(x > xp[:, n - 1:], fp[:, n - 1:], f)
    return f
