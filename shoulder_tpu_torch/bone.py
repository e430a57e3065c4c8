"""Humerus / ProximalHumerus facades (PyTorch).

Port of shoulder_tpu/bone.py, with the same public surface (the
published `trans_epiconylar` spelling included).  The first landmark
access runs `compute_landmarks` on the bone's device and caches every
CT-frame result as numpy float64; accessors re-project through the shared
Transform on each read.  Coordinate-system matrices are built in float32,
as the JAX facade builds them (utils/geometry.host_f32).

The constructors take one keyword the JAX package does not have,
`device` (default "cuda"): where the landmarks and slice views run.
There is no CPU fallback: without a card, `device="cuda"` raises.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from shoulder_tpu_torch import config as cfg_mod
from shoulder_tpu_torch.base import Bone, Landmark, Plane, Transform
from shoulder_tpu_torch.io import ingest
from shoulder_tpu_torch.io.mesh import Mesh
from shoulder_tpu_torch.models import forest
from shoulder_tpu_torch.pipeline import batch as batch_mod
from shoulder_tpu_torch.pipeline.landmarks import compute_landmarks
from shoulder_tpu_torch.utils import geometry as geom
from shoulder_tpu_torch.utils import trace


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _tp(pts, matrix):
    return np.asarray(pts) @ np.asarray(matrix)[:3, :3].T + np.asarray(matrix)[:3, 3]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the host"
        )
    return dev


class _LandmarkView(Landmark):
    def __init__(self, bone: "ProximalHumerus", plot_name: str):
        self._bone = bone
        self._tfrm = bone._tfrm
        self._plot_name = plot_name
        self._accessed = False

    def _lm(self):
        return self._bone._landmarks()

    def transform_landmark(self) -> None:
        pass  # projections recompute on read

    def _scatter(self, pts):
        return {
            "type": "scatter3d",
            "name": self._plot_name,
            "x": pts[:, 0].tolist(),
            "y": pts[:, 1].tolist(),
            "z": pts[:, 2].tolist(),
        }


class Canal(_LandmarkView):
    """Canal centerline."""

    def points(self, cutoff_pcts=(0.35, 0.75)) -> np.ndarray:
        """Canal-window slice centroids in the current frame.

        A non-default ``cutoff_pcts`` re-runs the pipeline with that
        line-fit window and it STICKS: later default-argument calls —
        including every internal call the csys/metric paths make — reuse
        it; a later different non-default window recomputes.
        """
        self._accessed = True
        if tuple(cutoff_pcts) != (0.35, 0.75):
            self._bone._set_params(canal_cutoff=tuple(cutoff_pcts))
        lm = self._lm()
        pts = lm["canal_points"]
        self._points = _tp(pts, self._tfrm.matrix)
        return self._points

    def axis(self, cutoff_pcts=(0.35, 0.75)) -> np.ndarray:
        """Two endpoints of the canal line fit.

        Window semantics identical to :meth:`points`: only a non-default
        ``cutoff_pcts`` asserts a window; default-argument calls reuse
        whatever window the landmarks were computed with."""
        self._accessed = True
        if tuple(cutoff_pcts) != (0.35, 0.75):
            self._bone._set_params(canal_cutoff=tuple(cutoff_pcts))
        lm = self._lm()
        self._axis = _tp(lm["canal_axis"], self._tfrm.matrix)
        return self._axis

    def get_transform(self) -> np.ndarray:
        """CT -> canal csys: z = canal direction, x = OBB x projected
        orthogonal to it, origin at the axis midpoint.  Uses the axis as
        last returned (current frame)."""
        ax = self.axis() if getattr(self, "_axis", None) is None else self._axis
        ax = np.asarray(ax, dtype=np.float64)
        z_hat = ax[0] - ax[1]
        z_hat /= np.linalg.norm(z_hat)
        x_hat = np.asarray(self._bone._spec.obb_transform)[:3, 0].astype(
            np.float64
        ).copy()
        x_hat -= z_hat * np.dot(x_hat, z_hat) / np.dot(z_hat, z_hat)
        x_hat /= np.linalg.norm(x_hat)
        y_hat = np.cross(z_hat, x_hat)
        y_hat /= np.linalg.norm(y_hat)
        pos = ax.mean(axis=0)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x_hat, y_hat, z_hat, pos
        # rigid inverse: CT -> canal csys
        out = np.eye(4)
        out[:3, :3] = m[:3, :3].T
        out[:3, 3] = -m[:3, :3].T @ pos
        return out

    @property
    def _axis_ct(self):
        return self._lm()["canal_axis"]

    def _graph_obj(self):
        if not self._accessed:
            return None
        return self._scatter(self.points())


class SurgicalNeck(_LandmarkView):
    """Surgical-neck contour."""

    @property
    def points(self) -> np.ndarray:
        self._accessed = True
        lm = self._lm()
        return _tp(lm["sn_points"], self._tfrm.matrix)

    @property
    def points_ct(self) -> np.ndarray:
        return self._lm()["sn_points"]

    @property
    def neck_z(self) -> float:
        return float(self._lm()["neck_z"])

    def cutoff_zs(self, bottom_pct=0.35, top_pct=0.85):
        """OBB-frame zs between the surgical neck (0) and head top (1)."""
        z_max = float(self._bone._spec.z_bounds[1])
        span = z_max - self.neck_z
        return [self.neck_z + span * bottom_pct, self.neck_z + span * top_pct]

    def z_percent(self) -> float:
        z_min, z_max = self._bone._spec.z_bounds
        return (self.neck_z - z_min) / (abs(z_min) + abs(z_max))

    def _graph_obj(self):
        if not self._accessed:
            return None
        return self._scatter(self.points)


class DeepGroove(_LandmarkView):
    """Bicipital groove."""

    def points(self, cutoff_pcts=(0.2, 0.75), deg_window=7) -> np.ndarray:
        """Groove polyline in the current frame.

        Non-default ``cutoff_pcts`` (detection window over the proximal
        stack) or ``deg_window`` (per-slice radial-argmin half-window in
        degrees) re-run the pipeline with those values and stick for
        later default-argument calls, internal ones included."""
        self._accessed = True
        overrides = {}
        if tuple(cutoff_pcts) != (0.2, 0.75):
            overrides["groove_cutoff"] = tuple(cutoff_pcts)
        if float(deg_window) != 7.0:
            overrides["groove_deg_window"] = float(deg_window)
        if overrides:
            self._bone._set_params(**overrides)
        lm = self._lm()
        self._points = _tp(lm["bg_points"], self._tfrm.matrix)
        return self._points

    def axis(self) -> np.ndarray:
        self._accessed = True
        lm = self._lm()
        self._axis = _tp(lm["bg_axis"], self._tfrm.matrix)
        return self._axis

    @property
    def bg_theta(self) -> float:
        return float(self._lm()["bg_theta"])

    @property
    def _points_ct(self):
        return self._lm()["bg_points"]

    def _graph_obj(self):
        if not self._accessed:
            return None
        return self._scatter(self.points())


class AnatomicNeck(_LandmarkView):
    """Anatomic neck plane / rim / axes."""

    def points(self) -> np.ndarray:
        self._accessed = True
        lm = self._lm()
        self._points = _tp(lm["anp_points"], self._tfrm.matrix)
        return self._points

    def plane(self):
        """Anatomic neck plane in the current frame."""
        self._accessed = True
        lm = self._lm()
        m = self._tfrm.matrix
        point = _tp(lm["anp_plane_point"][None], m)[0]
        normal = np.asarray(m)[:3, :3] @ lm["anp_plane_normal"]
        return Plane(point, normal)

    def plane_points(self) -> np.ndarray:
        self._accessed = True
        lm = self._lm()
        if "anp_plane_points" not in lm:
            # mesh section by the ANP plane in the CT frame
            loops = self._bone._mesh_ct.section(
                lm["anp_plane_normal"], lm["anp_plane_point"]
            )
            pts = (
                np.concatenate([l["points"] for l in loops])
                if loops else np.zeros((0, 3))
            )
            lm["anp_plane_points"] = pts
        return _tp(lm["anp_plane_points"], self._tfrm.matrix)

    def axis_normal(self) -> np.ndarray:
        self._accessed = True
        return _tp(self._lm()["anp_axis_normal"], self._tfrm.matrix)

    def axis_central(self) -> np.ndarray:
        self._accessed = True
        return _tp(self._lm()["anp_axis_central"], self._tfrm.matrix)

    @property
    def _normal_axis_ct(self):
        return self._lm()["anp_axis_normal"]

    @property
    def _central_axis_ct(self):
        return self._lm()["anp_axis_central"]

    def _graph_obj(self):
        if not self._accessed:
            return None
        out = [self._scatter(self.points())]
        out[0]["mode"] = "markers"
        pp = self.plane_points()
        if len(pp):
            tr = self._scatter(pp)
            tr["mode"] = "markers"
            tr["name"] = "Anatomic Neck Plane"
            out.append(tr)
        return out


class TransEpicondylar(_LandmarkView):
    """Transepicondylar axis."""

    def axis(self, num_slices: int = 50) -> np.ndarray:
        """Medial-first transepicondylar axis endpoints.

        ``num_slices`` is accepted for signature parity with the JAX
        package and has no effect: the search always runs over the distal
        stack's (0.8, 0.99) window."""
        self._accessed = True
        lm = self._lm()
        self._axis = _tp(lm["te_axis"], self._tfrm.matrix)
        return self._axis

    @property
    def _axis_ct(self):
        return self._lm()["te_axis"]

    def _graph_obj(self):
        if not self._accessed:
            return None
        tr = self._scatter(self.axis())
        tr["name"] = "Transverse Epicondylar Axis"
        return tr


class ProximalHumerus(Bone):
    """Proximal-humerus facade."""

    _proximal = True

    def __init__(self, stl_file,
                 config: cfg_mod.PipelineConfig | None = None,
                 validate: bool = False, device="cuda"):
        """``config``: the pipeline's configuration; without one, the
        smallest of ``config.PADDINGS`` that holds the mesh.
        ``validate=True`` runs the landmarks before the constructor
        returns, so degenerate meshes raise here instead of at first
        landmark access.  The default stays lazy: the first access
        computes every landmark at once.  ``device``: where the landmarks
        and slice views run (raises when it names an absent card)."""
        with trace.span("humerus.init"):
            self._device = _device(device)
            self._tfrm = Transform()
            self.transform = self._tfrm.matrix
            with trace.span("humerus.load"):
                self._spec = ingest.load_bone(
                    stl_file, proximal=self._proximal, config=config)
                self._cfg = self._spec.config
                self.stl_file = Path(stl_file)
                self._mesh_ct = Mesh(self._spec.vertices_raw,
                                     self._spec.faces_raw,
                                     self._spec.neighbors_raw)
                self.mesh = self._mesh_ct.copy()
            self._lm_cache = None
            self._param_overrides = {}
            self._views()
            if validate:
                self._validate_landmarks()

    def _views(self) -> None:
        """The landmark views (a subclass adds its own)."""
        self.canal = Canal(self, "Canal Axis")
        self.surgical_neck = SurgicalNeck(self, "Surgical Neck")
        self.bicipital_groove = DeepGroove(self, "Bicipital Groove")
        self.anatomic_neck = AnatomicNeck(self, "Anatomic Neck")

    @trace.spanned("humerus.validate")
    def _validate_landmarks(self) -> None:
        """Force the landmark program and fail fast on degenerate output."""
        lm = self._landmarks()
        core = np.concatenate(
            [np.ravel(lm["canal_axis"]), [lm["neck_z"], lm["neckshaft"]]]
        )
        if not np.all(np.isfinite(core)):
            raise ValueError(
                f"{self._spec.name}: landmark computation produced "
                "non-finite core landmarks (degenerate mesh?) — "
                f"qc={lm['qc']}"
            )

    # ------------------------------------------------------------- params
    def _set_params(self, **overrides) -> None:
        """Record landmark-parameter overrides (canal/groove windows).

        Callers (the landmark views) only invoke this for explicitly
        non-default arguments, so internal csys/metric paths — which call
        the views with default args — can never wipe a user's custom
        window.  If an override changes the value the cached landmarks
        were computed with, the cache is invalidated so the next access
        recomputes with the new parameters."""
        changed = False
        for k, v in overrides.items():
            if getattr(self._effective_cfg(), k) != v:
                self._param_overrides[k] = v
                changed = True
        if changed:
            self._lm_cache = None

    def _effective_cfg(self) -> cfg_mod.PipelineConfig:
        if not self._param_overrides:
            return self._cfg
        return dataclasses.replace(self._cfg, **self._param_overrides)

    # ------------------------------------------------------------- compute
    def _landmarks(self) -> dict:
        if self._lm_cache is None:
            with trace.span("humerus.landmarks"):
                self._lm_cache = self._compute_landmarks()
        return self._lm_cache

    def _compute_landmarks(self) -> dict:
        """Every landmark of the bone, on its device, as host numpy."""
        bt = batch_mod.bone_tensors(self._spec, self._device)
        lm = compute_landmarks(
            bt, forest.load_params(self._device),
            proximal=self._proximal, cfg=self._effective_cfg())
        lm = batch_mod.landmarks_to_numpy(lm)
        d = {}
        d["canal_points"] = _np(lm.canal_points[np.asarray(lm.canal_mask)])
        d["canal_axis"] = _np(lm.canal_axis)
        d["neck_z"] = float(lm.neck_z)
        d["sn_points"] = _np(lm.sn_points[: int(lm.sn_n)])
        d["bg_points"] = _np(lm.bg_points)
        d["bg_axis"] = _np(lm.bg_axis)
        d["bg_theta"] = float(lm.bg_theta)
        d["anp_points"] = _np(lm.anp_points[: int(lm.anp_n)])
        d["anp_plane_point"] = _np(lm.anp_plane_point)
        d["anp_plane_normal"] = _np(lm.anp_plane_normal)
        d["anp_axis_normal"] = _np(lm.anp_axis_normal)
        d["anp_axis_central"] = _np(lm.anp_axis_central)
        d["te_axis"] = _np(lm.te_axis)
        d["side"] = "left" if bool(lm.side_is_left) else "right"
        d["retroversion"] = float(lm.retroversion)
        d["neckshaft"] = float(lm.neckshaft)
        d["radius_curvature"] = float(lm.radius_curvature)
        d["qc"] = {
            "rf_pos_frac": float(lm.qc_rf_pos_frac),
            "mask_area_frac": float(lm.qc_mask_area_frac),
            "sphere_resid_mm": float(lm.qc_sphere_resid),
            "canal_fit_rms_mm": float(lm.qc_canal_fit_rms),
            "slice_band_overflow": bool(lm.qc_slice_overflow),
            "peak_capacity_overflow": bool(lm.qc_peak_overflow),
            "open_edges": bool(lm.qc_open_edges),
        }
        return d

    # ------------------------------------------------------ slice access
    @property
    def full_slices(self):
        """Slice accessors over the 200x100 full-bone stack."""
        if getattr(self, "_full_slices_view", None) is None:
            from shoulder_tpu_torch import slices as slices_mod

            self._full_slices_view = slices_mod.full_slices(
                self._spec, self._cfg, self._device
            )
        return self._full_slices_view

    @property
    def proximal_slices(self):
        """The 600x512 proximal stack (head -> surgical neck)."""
        if getattr(self, "_prox_slices_view", None) is None:
            from shoulder_tpu_torch import slices as slices_mod

            self._prox_slices_view = slices_mod.proximal_slices(
                self._spec, self._landmarks()["neck_z"], self._cfg,
                self._device
            )
        return self._prox_slices_view

    # ------------------------------------------------------------- metrics
    def side(self) -> str:
        return self._landmarks()["side"]

    def neckshaft(self) -> float:
        return self._landmarks()["neckshaft"]

    def radius_curvature(self) -> float:
        return self._landmarks()["radius_curvature"]

    def quality(self) -> dict:
        """Per-bone QC diagnostics (fit residuals, RF vote mass, mask area,
        overflow and open-edge flags)."""
        return self._landmarks()["qc"]

    # --------------------------------------------------------------- csys
    @trace.spanned("humerus.csys")
    def apply_csys_canal_articular(self) -> np.ndarray:
        lm = self._landmarks()
        self.canal.axis()
        self.anatomic_neck.axis_central()
        self.anatomic_neck.axis_normal()
        self._tfrm.matrix = geom.host_f32(
            geom.construct_csys, lm["canal_axis"], lm["anp_axis_normal"]
        )
        self._update_landmark_data()
        self.mesh = self._mesh_ct.copy().apply_transform(self._tfrm.matrix)
        self.transform = self._tfrm.matrix
        return self.transform

    @trace.spanned("humerus.csys")
    def apply_csys_obb(self) -> np.ndarray:
        self._tfrm.matrix = np.asarray(self._spec.obb_transform)
        self._update_landmark_data()
        self.mesh = self._mesh_ct.copy().apply_transform(self._tfrm.matrix)
        self.transform = self._tfrm.matrix
        return self.transform

    @trace.spanned("humerus.csys")
    def apply_csys_ct(self) -> np.ndarray:
        self._tfrm.reset()
        self._update_landmark_data()
        self.mesh = self._mesh_ct.copy()
        self.transform = self._tfrm.matrix
        return self.transform

    @trace.spanned("humerus.csys")
    def apply_csys_custom(self, transform, from_ct=True) -> np.ndarray:
        if from_ct:
            self._tfrm.matrix = transform
            self._update_landmark_data()
            self.mesh = self._mesh_ct.copy().apply_transform(self._tfrm.matrix)
        else:
            self._tfrm.matrix = np.dot(transform, self._tfrm.matrix)
            self._update_landmark_data()
            self.mesh = self.mesh.apply_transform(self._tfrm.matrix)
        self.transform = self._tfrm.matrix
        return self.transform

    def apply_translation(self, translation) -> np.ndarray:
        t = geom.host_f32(geom.translate_transform, translation)
        self._tfrm.matrix = np.dot(t, self._tfrm.matrix)
        self._update_landmark_data()
        self.mesh = self.mesh.apply_transform(self._tfrm.matrix)
        self.transform = self._tfrm.matrix
        return self.transform


class Humerus(ProximalHumerus):
    """Full-humerus facade."""

    _proximal = False

    def _views(self) -> None:
        super()._views()
        # the published API spelling
        self.trans_epiconylar = TransEpicondylar(
            self, "Transverse Epicondylar Axis"
        )

    @property
    def distal_slices(self):
        """The 200x500 distal stack (elbow half)."""
        if getattr(self, "_dist_slices_view", None) is None:
            from shoulder_tpu_torch import slices as slices_mod

            self._dist_slices_view = slices_mod.distal_slices(
                self._spec, self._cfg, self._device
            )
        return self._dist_slices_view

    def retroversion(self) -> float:
        return self._landmarks()["retroversion"]

    @trace.spanned("humerus.csys")
    def apply_csys_canal_transepiconylar(self) -> np.ndarray:
        lm = self._landmarks()
        self.canal.axis()
        self.trans_epiconylar.axis()
        self._tfrm.matrix = geom.host_f32(
            geom.construct_csys, lm["canal_axis"], lm["te_axis"]
        )
        self._update_landmark_data()
        self.mesh = self._mesh_ct.copy().apply_transform(self._tfrm.matrix)
        self.transform = self._tfrm.matrix
        return self.transform
