"""The staged landmark pipeline over a bone batch (PyTorch).

Port of shoulder_tpu/pipeline/landmarks.py.  Stages:
  A. full-bone contour stack
  B. surgical neck (changepoint on areas, then one banded raw loop)
  C. proximal contour stack
  D. canal axis
  E. bicipital groove (find_peaks, random forest, KDE)
  F. anatomic neck (polar image, UNet or sphere segmenter, rays)
  G. transepicondylar axis (full bones only)
  H. side, retroversion, neck-shaft angle, head radius

All landmark outputs are in the CT frame.  Every stage runs on a
leading bone dimension (B, ...), where the JAX package vmaps
compute_landmarks over the bones: one set of launches per batch, with no
loop over bones and no host read.  Per-slice work runs over a slice
dimension (B, S, ...), folded into B·S rows where an op takes rows.
Every reduction that JAX's vmap makes per bone (the groove's scaler and
KDE, the image normalisation, the fits, the RANSAC consensus, the QC
flags) stays per bone here.  `landmarks_batch` is the body;
`compute_landmarks`, one bone, is its B = 1 case.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from shoulder_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from shoulder_tpu_torch.models import segment
from shoulder_tpu_torch.models import unet as unet_mod
from shoulder_tpu_torch.models.forest import ForestParams, predict_proba
from shoulder_tpu_torch.ops import rays, rect
from shoulder_tpu_torch.ops import signal as sig
from shoulder_tpu_torch.ops import slicing
from shoulder_tpu_torch.utils import fits
from shoulder_tpu_torch.utils import geometry as geom


class BoneTensors(NamedTuple):
    """Per-bone tensors on one device (a leading batch dim when stacked;
    the shapes below are one bone's)."""

    verts: torch.Tensor          # (V,3) f32, CT frame, padded
    faces: torch.Tensor          # (F,3) i32, presorted by OBB-frame z_min
    neighbors: torch.Tensor      # (F,3) i32, sorted frame, -1 none
    obb_transform: torch.Tensor  # (4,4) f32 CT -> OBB
    z_min: torch.Tensor          # () OBB-frame bounds
    z_max: torch.Tensor
    z_length: torch.Tensor
    cutoff_lo: torch.Tensor      # canal window (ProxObb) or default
    cutoff_hi: torch.Tensor
    face_orig: torch.Tensor      # (F,) i32 original STL index of each slot


class Landmarks(NamedTuple):
    """Everything the pipeline reports, in the CT frame (one bone's shapes
    below; a batch's carry a leading bone dim)."""

    canal_points: torch.Tensor       # (S_full,3)
    canal_mask: torch.Tensor         # (S_full,) bool
    canal_axis: torch.Tensor         # (2,3)
    neck_z: torch.Tensor             # () OBB frame
    sn_points: torch.Tensor          # (max_chain,3)
    sn_n: torch.Tensor               # ()
    bg_points: torch.Tensor          # (S_g,3)
    bg_axis: torch.Tensor            # (2,3)
    bg_theta: torch.Tensor           # ()
    anp_points: torch.Tensor         # (2048,3) neck-rim points
    anp_n: torch.Tensor
    anp_plane_point: torch.Tensor    # (3,)
    anp_plane_normal: torch.Tensor   # (3,)
    anp_axis_normal: torch.Tensor    # (2,3)
    anp_axis_central: torch.Tensor   # (2,3)
    te_axis: torch.Tensor            # (2,3) (zeros for proximal-only)
    side_is_left: torch.Tensor       # () bool
    retroversion: torch.Tensor       # () deg (nan for proximal-only)
    neckshaft: torch.Tensor          # () deg
    radius_curvature: torch.Tensor   # () mm
    qc_rf_pos_frac: torch.Tensor
    qc_mask_area_frac: torch.Tensor
    qc_sphere_resid: torch.Tensor
    qc_canal_fit_rms: torch.Tensor
    qc_slice_overflow: torch.Tensor  # () bool: a slice band or compaction
    #   was too small for its crossed faces
    qc_peak_overflow: torch.Tensor   # () bool: a groove slice had more
    #   local maxima than cfg.groove_cand_cap slots
    qc_open_edges: torch.Tensor      # () bool: a contour chain dead-ended
    #   at an open mesh edge


def _cutoff_bounds(n: int, cutoff):
    """Reference Slices._cutoff index semantics (slice.py:157-164)."""
    return int((1 - cutoff[1]) * n), int((1 - cutoff[0]) * n)


def _to_ct(pts, obb_transform):
    return geom.transform_pts(pts, geom.inv_transform(obb_transform))


def _take(x, i):
    """x[b, i[b]] for each bone b, x (B, n, ...) and i (B,): a gather on
    the device, without a host read."""
    idx = i.reshape(i.shape + (1,) * (x.dim() - 1))
    return x.gather(1, idx.expand((x.shape[0], 1) + x.shape[2:]))[:, 0]


def _pairs(a, b):
    """(B, 2, ...) from two (B, ...) endpoints."""
    return torch.stack([a, b], dim=1)


# --------------------------------------------------------------------- D
def _canal(stack: slicing.SliceStack, bone: BoneTensors, proximal: bool,
           cfg: PipelineConfig):
    n_bones, n = stack.zs.shape
    dev = stack.zs.device
    idx = torch.arange(n, device=dev)
    if proximal and tuple(cfg.canal_cutoff) == (0.35, 0.75):
        # the ingest-time OBB area scan's window, used only when the caller
        # left the cutoff at its default
        start = torch.floor((1.0 - bone.cutoff_hi) * n)[:, None]
        end = torch.floor((1.0 - bone.cutoff_lo) * n)[:, None]
        mean_cut = 0.5 * (bone.cutoff_lo + bone.cutoff_hi)
    else:
        s, e = _cutoff_bounds(n, cfg.canal_cutoff)
        start = torch.full((n_bones, 1), s, device=dev)
        end = torch.full((n_bones, 1), e, device=dev)
        mean_cut = torch.full(
            (n_bones,), 0.5 * (cfg.canal_cutoff[0] + cfg.canal_cutoff[1]),
            dtype=torch.float32, device=dev)
    mask = (idx >= start) & (idx < end)

    pts = torch.cat([stack.centroids, stack.zs[..., None]], dim=-1)
    w = mask.to(pts.dtype)
    center, direction = fits.fit_line(pts, w)
    direction = torch.where(direction[:, 2:3] < 0, -direction, direction)

    half = (bone.z_length * mean_cut / 2.0)[:, None]
    axis_obb = _pairs(center + direction * half, center - direction * half)

    d = pts - center[:, None, :]
    perp = d - (d @ direction[..., None]) * direction[:, None, :]
    rms = torch.sqrt(torch.sum(torch.sum(perp**2, dim=-1) * w, dim=-1)
                     / torch.clamp(w.sum(dim=-1), min=1))

    points_ct = _to_ct(pts, bone.obb_transform)
    axis_ct = _to_ct(axis_obb, bone.obb_transform)
    return points_ct, mask, axis_ct, axis_obb, rms


# --------------------------------------------------------------------- B
_NECK_MIN_K = 512  # the JAX package's slots for the surgical-neck plane


def _surgical_neck(stack, bone: BoneTensors, proximal: bool,
                   cfg: PipelineConfig, max_chain: int, sg):
    n = stack.zs.shape[1]
    cut = (cfg.surgical_neck_cutoff_prox if proximal
           else cfg.surgical_neck_cutoff_full)
    s, e = _cutoff_bounds(n, cut)
    t = sig.rbf_changepoint_1bkp(stack.areas[:, s:e],
                                 min_size=cfg.cpd_min_size)
    neck_z = _take(stack.zs[:, s:e], t)

    band = min(cfg.full.band, bone.faces.shape[1])
    # the JAX package gives this plane slice_raw_banded's default 512 slots
    # whatever the config; a 1.0 mm CT mesh crosses more (574 on
    # chip_smoke.py's CT bone 0), so the port gives it at least the
    # stacks' slots
    raw, overflow = slicing.slice_raw_banded(
        sg, neck_z, band, max_chain, "central",
        k=max(_NECK_MIN_K, cfg.slice_compact_k))
    pts3 = torch.cat([raw.points,
                      neck_z[:, None, None].expand(-1, max_chain, 1)], dim=-1)
    pts_ct = _to_ct(pts3, bone.obb_transform)
    valid = torch.arange(max_chain, device=pts3.device) < raw.n[:, None]
    pts_ct = torch.where(valid[..., None], pts_ct, 0.0)
    return neck_z, pts_ct, raw.n, overflow


# ---------------------------------------------------------------- polar
def _to_polar_start(contour, center):
    """theta/r of contours (..., N, 2) about centers (..., 2), each row
    rolled so its argmin(theta) leads."""
    d = contour - center[..., None, :]
    theta = torch.atan2(d[..., 1], d[..., 0])
    r = torch.linalg.vector_norm(d, dim=-1)
    n = theta.shape[-1]
    shift = torch.argmin(theta, dim=-1, keepdim=True)
    roll = (torch.arange(n, device=theta.device) + shift) % n
    return theta.gather(-1, roll), r.gather(-1, roll)


# --------------------------------------------------------------------- E
def _groove(prox: slicing.SliceStack, bone: BoneTensors, canal_axis_ct,
            rf: ForestParams, cfg: PipelineConfig):
    n_bones, n = prox.zs.shape
    interp = cfg.proximal.interp_num
    s, e = _cutoff_bounds(n, cfg.groove_cutoff)
    contours = prox.contours[:, s:e]       # (B,S,N,2)
    cents = prox.centroids[:, s:e]
    zs = prox.zs[:, s:e]
    S = e - s
    K = cfg.groove_max_peaks
    dev = zs.device
    ar = torch.arange(interp, device=dev)

    theta, r = _to_polar_start(contours, cents)             # (B,S,N) each
    r0 = r - r.mean(dim=-1, keepdim=True)

    # per-slice peaks of the negated, smoothed radius rolled to its minimum
    radius = sig.savgol_filter(-r0, cfg.groove_savgol_window,
                               cfg.groove_savgol_polyorder)
    rmin = torch.argmin(radius, dim=-1, keepdim=True)
    rolled = radius.gather(-1, (ar + rmin) % interp)
    p = sig.find_peaks(
        rolled.reshape(n_bones * S, interp), cfg.groove_peak_height,
        cfg.groove_peak_prominence, cfg.groove_peak_width,
        max_peaks=cfg.max_peaks_per_slice, cand_cap=cfg.groove_cand_cap,
    )
    p = {key: v.reshape((n_bones, S) + v.shape[1:]) for key, v in p.items()}
    idx = ((p["idx"] + rmin) % interp)[..., :K]
    valid = p["valid"][..., :K]
    prom, widths, whs = (p["prominences"][..., :K], p["widths"][..., :K],
                         p["width_heights"][..., :K])
    n_pk = torch.clamp(p["n_peaks"], max=K)
    peak_overflow = p["overflow"].any(dim=-1)

    pk_theta = theta.gather(-1, idx)
    pk_radius = r.gather(-1, idx)

    # nearest / next-nearest wrapped angular gaps among a slice's peaks,
    # excluding gaps that round to 0 at 2 decimals
    dth = pk_theta[..., :, None] - pk_theta[..., None, :]
    gap = torch.abs(torch.atan2(torch.sin(dth), torch.cos(dth)))
    ok = valid[..., :, None] & valid[..., None, :]
    ok = ok & (torch.round(gap, decimals=2) != 0.0)
    g = torch.sort(torch.where(ok, gap, torch.inf), dim=-1).values
    near = torch.where(torch.isfinite(g[..., 0]), g[..., 0], 0.0)
    nextn = torch.where(torch.isfinite(g[..., 1]), g[..., 1], 0.0)
    near = torch.where(n_pk[..., None] <= 1, 0.0, near)
    nextn = torch.where(n_pk[..., None] <= 2, 0.0, nextn)

    # per bone: its own slices' z range
    z_lo = zs.amin(dim=-1, keepdim=True)
    z_scale = (zs - z_lo) / (zs.amax(dim=-1, keepdim=True) - z_lo)
    pk_z = z_scale[..., None].expand(n_bones, S, K)

    # canal distance feature with the reference's frame quirk: CT-frame
    # canal direction scaled by the OBB z
    canal_u = geom.unit_vector(canal_axis_ct[:, 0], canal_axis_ct[:, 1])
    canal_xy = canal_u[:, None, None, :2] * zs[..., None, None]
    pk_xy = torch.stack([pk_radius * torch.cos(pk_theta),
                         pk_radius * torch.sin(pk_theta)], dim=-1)
    pk_canal_dist = torch.linalg.vector_norm(pk_xy - canal_xy, dim=-1)
    pk_num = (n_pk / K)[..., None].expand(n_bones, S, K).to(torch.float32)

    feats = torch.stack(
        [pk_radius, near, nextn, pk_z, prom, widths, whs, pk_canal_dist,
         pk_num], dim=-1,
    ).reshape(n_bones, S * K, 9)
    row_valid = valid.reshape(n_bones, S * K)

    # per-bone StandardScaler over the bone's valid rows
    w = row_valid.to(torch.float32)[..., None]
    wsum = torch.clamp(w.sum(dim=1), min=1.0)[:, None]
    mean = torch.sum(feats * w, dim=1, keepdim=True) / wsum
    var = torch.sum(w * (feats - mean) ** 2, dim=1, keepdim=True) / wsum
    x = (feats - mean) / torch.sqrt(torch.clamp(var, min=1e-12))
    x = torch.where(w > 0, x, 0.0)

    proba = predict_proba(rf, x.reshape(n_bones * S * K, 9))[:, 1]
    proba = proba.reshape(n_bones, S * K)

    # linear-kernel KDE over each bone's positive peak angles -> its
    # groove angle
    pos = row_valid & (proba > cfg.groove_rf_threshold)
    kde_w = pos.to(torch.float32)
    kde_w = torch.where(kde_w.sum(dim=-1, keepdim=True) > 0, kde_w,
                        row_valid.to(torch.float32) * proba)
    grid = geom.linspace(-math.pi, math.pi, cfg.groove_kde_bins, device=dev)
    bg_theta, _ = sig.kde_linear_argmax(pk_theta.reshape(n_bones, S * K),
                                        kde_w, grid)

    # per-slice windowed argmin around bg_theta, cyclic
    ivar = max(int(round(cfg.groove_deg_window / (360.0 / interp))), 1)
    esti = torch.clamp((theta < bg_theta[:, None, None]).sum(
        dim=-1, keepdim=True), max=interp - 1)
    win = (esti - ivar + torch.arange(2 * ivar, device=dev)) % interp
    off = torch.argmin(r0.gather(-1, win), dim=-1, keepdim=True)
    j = (esti - ivar + off) % interp
    r_j, th_j = r.gather(-1, j)[..., 0], theta.gather(-1, j)[..., 0]
    bg_xy = torch.stack([r_j * torch.cos(th_j), r_j * torch.sin(th_j)],
                        dim=-1)
    bg_xyz = torch.cat([bg_xy + cents, zs[..., None]], dim=-1)

    # groove axis: unsigned line fit spanning the points' z extent
    center, direction = fits.fit_line(bg_xyz)
    z_dist = (bg_xyz[..., 2].amax(dim=-1) - bg_xyz[..., 2].amin(dim=-1))
    z_dist = z_dist[:, None]
    axis_obb = _pairs(center + direction * z_dist / 2.0,
                      center - direction * z_dist / 2.0)

    bg_points_ct = _to_ct(bg_xyz, bone.obb_transform)
    bg_axis_ct = _to_ct(axis_obb, bone.obb_transform)
    rf_pos_frac = pos.sum(dim=-1) / torch.clamp(row_valid.sum(dim=-1), min=1)
    return bg_points_ct, bg_axis_ct, bg_theta, rf_pos_frac, peak_overflow


# --------------------------------------------------------------------- F
def _anp_image_points(prox: slicing.SliceStack, bg_theta,
                      cfg: PipelineConfig):
    """The anatomic-neck polar images (B, R, N), each normalised over its
    own bone, and their per-pixel OBB-frame surface points (B, R, N, 3)."""
    n_bones, n = prox.zs.shape
    interp = cfg.proximal.interp_num
    s, e = _cutoff_bounds(n, cfg.anp_cutoff)
    contours = prox.contours[:, s:e]       # (B,R,N,2)
    zs = prox.zs[:, s:e]
    R = e - s
    dev = zs.device

    th, r = _to_polar_start(contours, torch.zeros((n_bones, R, 2),
                                                  device=dev))
    # even-theta resample from th[0] to th[-2] over th[:-1]; the grid is
    # built as th0 + j*step so interp_ascending's bucket correction and the
    # groove-angle roll below are closed-form
    th0 = th[..., 0]
    step = (th[..., -2] - th0) / (interp - 1)
    jf = torch.arange(interp, dtype=th.dtype, device=dev)
    t_samp = th0[..., None] + jf * step[..., None]
    rows = n_bones * R
    r_i = sig.interp_ascending(
        t_samp.reshape(rows, interp), th[..., :-1].reshape(rows, -1),
        r[..., :-1].reshape(rows, -1),
        grid=(th0.reshape(rows), step.reshape(rows)),
    ).reshape(n_bones, R, interp)
    # roll so the groove angle leads; the rolled uniform grid is arithmetic
    shift = torch.argmin(torch.abs(t_samp - bg_theta[:, None, None]), dim=-1,
                         keepdim=True)
    jr = (torch.arange(interp, device=dev) + shift) % interp
    t_im = th0[..., None] + jr.to(th.dtype) * step[..., None]
    r_im = r_i.gather(-1, jr)

    r_lo = r_im.amin(dim=(-2, -1), keepdim=True)
    image = (r_im - r_lo) / (r_im.amax(dim=(-2, -1), keepdim=True) - r_lo)
    pts = torch.stack([r_im * torch.cos(t_im), r_im * torch.sin(t_im),
                       zs[..., None].expand(n_bones, R, interp)], dim=-1)
    return image, pts


def _anatomic_neck(prox: slicing.SliceStack, bone: BoneTensors, bg_theta,
                   cfg: PipelineConfig, seg_model=None, hyp_idx=None,
                   out_n: int = 2048):
    image, pts = _anp_image_points(prox, bg_theta, cfg)
    r, c = image.shape[-2:]
    if hyp_idx is None:
        hyp_idx = segment.ransac_indices(int(0.4 * r) * c, image.device)
    sphere_args = (pts, hyp_idx, cfg.sphere_seg_iters, cfg.sphere_seg_tol_mm,
                   cfg.sphere_seg_init_top_rows)
    if cfg.segmenter == "unet":
        # the UNet mask seeds the sphere consensus and supports the final
        # mask up to sphere_seg_support_tol x tol from the sphere; the
        # batch's images go through one forward pass
        unary = unet_mod.segment_image(seg_model, image)
        unary = segment._longest_cyclic_run_per_row(unary > 0.5).to(image.dtype)
        mask, _rad, _cen, sph_resid = segment.sphere_segment(
            *sphere_args, init_mask=unary, support_mask=unary,
            support_tol_factor=cfg.sphere_seg_support_tol,
            support_min_disagree=cfg.sphere_seg_support_min_disagree,
            support_max_disagree=cfg.sphere_seg_support_max_disagree,
            support_min_recall=cfg.sphere_seg_support_min_recall,
            support_rescue_max_frac=cfg.sphere_seg_support_rescue_frac,
        )
    else:
        mask, _rad, _cen, sph_resid = segment.sphere_segment(*sphere_args)
    return _anp_from_mask(mask, pts, bone, sph_resid, out_n)


def _anp_from_mask(mask, pts, bone: BoneTensors, sph_resid,
                   out_n: int = 2048):
    """Rim extraction, plane fit, ellipse recenter, axis rays and radius of
    curvature from articular masks (B, R, N), each bone's fits over its
    own points."""
    # the rim is the cyclic theta-direction mask transition
    maskb = mask > 0.5
    edge = maskb != torch.roll(maskb, 1, dims=-1)
    n_bones, dev = mask.shape[0], mask.device
    zeros = torch.zeros((n_bones, 1), device=dev)

    edge_flat = edge.reshape(n_bones, -1)
    pts_flat = pts.reshape(n_bones, -1, 3)
    anp_pts, anp_n = slicing.compact_points(pts_flat, edge_flat, out_n)
    anp_pts_ct = _to_ct(anp_pts, bone.obb_transform)
    anp_pts_ct = torch.where(
        (torch.arange(out_n, device=dev) < anp_n[:, None])[..., None],
        anp_pts_ct, 0.0)

    ew = edge_flat.to(torch.float32)
    p_pt, p_n = fits.fit_plane(pts_flat, ew)
    p_n = torch.where(p_n[:, 2:3] < 0, -p_n, p_n)

    to2d = geom.plane_transform(p_pt, p_n)
    pts2d = geom.transform_pts(pts_flat, to2d)[..., :2]
    ecenter, *_ = fits.fit_ellipse(pts2d, ew)
    center3 = geom.transform_pts(
        torch.cat([ecenter, zeros], dim=-1)[:, None, :],
        geom.inv_transform(to2d),
    )[:, 0]

    plane_pt_ct, plane_n_ct = geom.transform_plane(
        center3, p_n, geom.inv_transform(bone.obb_transform))

    # axis rays against each bone's OBB-frame mesh
    verts_obb = geom.transform_pts(bone.verts, bone.obb_transform)
    nc = torch.cat([p_n[:, :2], zeros], dim=-1)
    nc = nc / torch.linalg.vector_norm(nc, dim=-1, keepdim=True)
    hits, _, _ = rays.first_hits(
        verts_obb, bone.faces, center3[:, None, :].expand(n_bones, 4, 3),
        torch.stack([p_n, -p_n, nc, -nc], dim=1),
    )
    axis_normal_ct = _to_ct(hits[:, 0:2], bone.obb_transform)
    axis_central_ct = _to_ct(hits[:, 2:4], bone.obb_transform)

    # radius of curvature: sphere fit over all articular points
    rad, _cent = fits.fit_sphere(pts_flat, mask.reshape(n_bones, -1))
    return (
        anp_pts_ct, anp_n, plane_pt_ct, plane_n_ct,
        axis_normal_ct, axis_central_ct,
        center3, p_n,
        rad, mask.mean(dim=(-2, -1)), sph_resid,
    )


# --------------------------------------------------------------------- G
def _transepicondylar(distal: slicing.SliceStack, bone: BoneTensors,
                      canal_axis_ct, axis_central_ct, cfg: PipelineConfig):
    n_bones, n = distal.zs.shape
    s, e = _cutoff_bounds(n, cfg.epicondyle_cutoff)
    # a copy whatever B is, so the fold below is a view (reshape copies
    # the window only when B > 1)
    contours = distal.contours[:, s:e].clone()
    zs = distal.zs[:, s:e]

    rects = rect.min_rotated_rect(contours.reshape((-1,) + contours.shape[2:]))
    rects = rect.RotatedRect(*(f.reshape((n_bones, e - s) + f.shape[1:])
                               for f in rects))
    k = torch.argmax(rects.major_extent, dim=-1)
    contour = _take(contours, k)
    z_sel = _take(zs, k)
    r_sel = rect.RotatedRect(*(_take(f, k) for f in rects))

    out, _ = rect.end_slab_mask(contour, r_sel, cfg.epicondyle_yscale)
    m = cfg.epicondyle_max_fragments
    rid = rect.cyclic_runs(out, m)
    cents, _counts, valid = rect.run_chord_centroids(contour, rid, m)
    # the farthest-apart pair of fragment centroids
    d = torch.linalg.vector_norm(cents[:, :, None, :] - cents[:, None, :, :],
                                 dim=-1)
    d = torch.where(valid[:, :, None] & valid[:, None, :], d, -torch.inf)
    flat = torch.argmax(d.reshape(n_bones, m * m), dim=-1)
    end_pts = _pairs(_take(cents, flat // m), _take(cents, flat % m))
    end3 = torch.cat([end_pts, z_sel[:, None, None].expand(-1, 2, 1)], dim=-1)
    end_ct = _to_ct(end3, bone.obb_transform)

    # medial first, via the canal/head-central csys
    tfrm = geom.construct_csys(canal_axis_ct, axis_central_ct)
    in_csys = geom.transform_pts(end_ct, tfrm)
    flip = in_csys[:, 1, 0] < in_csys[:, 0, 0]
    return torch.where(flip[:, None, None], torch.flip(end_ct, [1]), end_ct)


# --------------------------------------------------------------------- H
def _metrics(canal_axis_ct, axis_normal_ct, axis_central_ct, te_axis_ct,
             bg_points_ct, proximal: bool):
    tf_central = geom.construct_csys(canal_axis_ct, axis_central_ct)
    bg_mean = geom.transform_pts(bg_points_ct, tf_central).mean(dim=-2)
    side_is_left = bg_mean[:, 1] <= 0

    tf_ns = geom.construct_csys(canal_axis_ct, axis_normal_ct)
    an = geom.transform_pts(axis_normal_ct, tf_ns)
    anu = geom.unit_vector(an[:, 0], an[:, 1])
    neckshaft = 180.0 - geom.unitxyz_to_spherical(anu)[:, 2]

    if proximal:
        retro = torch.full_like(neckshaft, float("nan"))
    else:
        tf_te = geom.construct_csys(canal_axis_ct, te_axis_ct)
        an2 = geom.transform_pts(axis_normal_ct, tf_te)
        an2u = geom.unit_vector(an2[:, 0], an2[:, 1])
        an2u = torch.cat([-an2u[:, :1], an2u[:, 1:]], dim=-1)
        theta = geom.unitxyz_to_spherical(an2u)[:, 1]
        retro = torch.where(side_is_left, theta, -theta)
    return side_is_left, retro, neckshaft


def landmarks_batch(
    bones: BoneTensors,
    rf: ForestParams,
    proximal: bool = False,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    chunk: int = 150,
    seg_model=None,
    hyp_idx=None,
) -> Landmarks:
    """Every landmark and metric of a stacked bone batch (every field
    (B, ...)), on the batch's device, in one set of launches: each slice
    stack is one slice_stack call over all B bones' planes.

    `seg_model`: the UNet (models.unet.load_model) when cfg.segmenter is
    "unet"; loaded here when not given.  `hyp_idx`: the (128, 4) RANSAC
    quadruples of the sphere segmenter, shared by every bone as under
    JAX's vmap; by default JAX's own draw (models.segment.ransac_indices).
    """
    if cfg.segmenter == "unet" and seg_model is None:
        seg_model = unet_mod.load_model(bones.verts.device)

    verts_obb = geom.transform_pts(bones.verts, bones.obb_transform)
    # the z-sorted face geometry depends only on the mesh: once per bone
    sg = slicing.sorted_geom(verts_obb, bones.faces, bones.neighbors,
                             bones.face_orig)

    def stack(zs, sset):
        return slicing.slice_stack(sg, zs, sset.interp_num, sset.band,
                                   cfg.slice_compact_k, chunk)

    # A: full stack (zs descending)
    full = stack(geom.linspace(cfg.z_inset * bones.z_max,
                               cfg.z_inset * bones.z_min,
                               cfg.full.zslice_num), cfg.full)

    # B: surgical neck
    neck_z, sn_points, sn_n, sn_overflow = _surgical_neck(
        full, bones, proximal, cfg, cfg.max_chain, sg)

    # C: proximal stack (head -> each bone's surgical neck)
    prox = stack(geom.linspace(cfg.z_inset * bones.z_max, neck_z,
                               cfg.proximal.zslice_num), cfg.proximal)

    # D: canal
    canal_pts, canal_mask, canal_axis, _canal_obb, canal_rms = _canal(
        full, bones, proximal, cfg)

    # E: bicipital groove
    bg_points, bg_axis, bg_theta, rf_pos_frac, peak_overflow = _groove(
        prox, bones, canal_axis, rf, cfg)

    # F: anatomic neck
    (anp_pts, anp_n, plane_pt, plane_n, axis_normal, axis_central,
     _plane_pt_obb, _plane_n_obb, radius, mask_frac, sph_resid,
     ) = _anatomic_neck(prox, bones, bg_theta, cfg, seg_model=seg_model,
                        hyp_idx=hyp_idx)

    # G: transepicondylar (full bones only)
    overflow = (full.overflow.any(dim=-1) | prox.overflow.any(dim=-1)
                | sn_overflow)
    open_edges = full.open_edges.any(dim=-1) | prox.open_edges.any(dim=-1)
    if proximal:
        te_axis = torch.zeros((verts_obb.shape[0], 2, 3),
                              device=verts_obb.device)
    else:
        distal = stack(geom.linspace(cfg.z_inset * bones.z_min, 0.0,
                                     cfg.distal.zslice_num), cfg.distal)
        te_axis = _transepicondylar(distal, bones, canal_axis, axis_central,
                                    cfg)
        overflow = overflow | distal.overflow.any(dim=-1)
        open_edges = open_edges | distal.open_edges.any(dim=-1)

    # H: metrics
    side_is_left, retro, neckshaft = _metrics(
        canal_axis, axis_normal, axis_central, te_axis, bg_points, proximal)

    return Landmarks(
        canal_points=canal_pts,
        canal_mask=canal_mask,
        canal_axis=canal_axis,
        neck_z=neck_z,
        sn_points=sn_points,
        sn_n=sn_n,
        bg_points=bg_points,
        bg_axis=bg_axis,
        bg_theta=bg_theta,
        anp_points=anp_pts,
        anp_n=anp_n,
        anp_plane_point=plane_pt,
        anp_plane_normal=plane_n,
        anp_axis_normal=axis_normal,
        anp_axis_central=axis_central,
        te_axis=te_axis,
        side_is_left=side_is_left,
        retroversion=retro,
        neckshaft=neckshaft,
        radius_curvature=radius,
        qc_rf_pos_frac=rf_pos_frac,
        qc_mask_area_frac=mask_frac,
        qc_sphere_resid=sph_resid,
        qc_canal_fit_rms=canal_rms,
        qc_slice_overflow=overflow,
        qc_peak_overflow=peak_overflow,
        qc_open_edges=open_edges,
    )


def compute_landmarks(
    bone: BoneTensors,
    rf: ForestParams,
    proximal: bool = False,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    chunk: int = 150,
    seg_model=None,
    hyp_idx=None,
) -> Landmarks:
    """Every landmark and metric of one bone, on the bone's device: the
    B = 1 case of `landmarks_batch` (same arguments)."""
    lm = landmarks_batch(BoneTensors(*(f[None] for f in bone)), rf,
                         proximal=proximal, cfg=cfg, chunk=chunk,
                         seg_model=seg_model, hyp_idx=hyp_idx)
    return Landmarks(*(x[0] for x in lm))
