"""Answers in the form harness/compare.py compares: the program's and
the reference's outputs for one input, split by kind."""

from __future__ import annotations

import numpy as np


def _row(x, i):
    return np.asarray(x)[i]


def from_landmarks(lm, i: int) -> dict:
    """Bone i of a Landmarks batch (numpy fields; the program's and the
    frozen copy's have the same fields)."""
    def g(f):
        return _row(getattr(lm, f), i)

    sn_n, anp_n, mask = int(g("sn_n")), int(g("anp_n")), g("canal_mask")
    # a loop or mask of another size shows as a shape that differs
    return {
        "mm": {
            "radius_curvature": g("radius_curvature"),
            "canal_axis": g("canal_axis"), "bg_axis": g("bg_axis"),
            "te_axis": g("te_axis"), "anp_plane_point": g("anp_plane_point"),
            "anp_axis_normal": g("anp_axis_normal"),
            "anp_axis_central": g("anp_axis_central"),
            "neck_z": g("neck_z"),
            "sn_points": g("sn_points")[:sn_n],
            "anp_points": g("anp_points")[:anp_n],
            "canal_points": g("canal_points")[mask],
            "bg_points": g("bg_points"),
            "qc_sphere_resid": g("qc_sphere_resid"),
            "qc_canal_fit_rms": g("qc_canal_fit_rms"),
        },
        "deg": {"retroversion": g("retroversion"),
                "neckshaft": g("neckshaft"),
                "bg_theta": np.degrees(np.float64(g("bg_theta")))},
        "unit": {"anp_plane_normal": g("anp_plane_normal")},
        "frac": {"qc_rf_pos_frac": g("qc_rf_pos_frac"),
                 "qc_mask_area_frac": g("qc_mask_area_frac")},
        "exact": {"side_is_left": bool(g("side_is_left")),
                  "qc_slice_overflow": bool(g("qc_slice_overflow")),
                  "qc_peak_overflow": bool(g("qc_peak_overflow")),
                  "qc_open_edges": bool(g("qc_open_edges"))},
    }


def with_mesh(answer: dict, spec) -> dict:
    """An answer of the CT path with its welded mesh (a BoneSpec)."""
    answer["mm"]["mesh_vertices"] = np.asarray(spec.vertices_raw,
                                                    np.float64)
    answer["exact"]["mesh_faces"] = int(spec.n_faces)
    answer["exact"]["mesh_verts"] = int(spec.n_verts)
    answer["exact"]["mesh_watertight"] = bool(spec.watertight)
    return answer


def from_cohort(d: dict) -> dict:
    """One bone of process_cohort's result list."""
    qc = d["qc"]
    return {
        "mm": {"radius_curvature": d["radius_curvature_mm"],
               "canal_axis": d["canal_axis_ct"], "te_axis": d["te_axis_ct"],
               "bg_axis": d["bg_axis_ct"],
               "anp_plane_point": d["anp_plane_point_ct"],
               "neck_z": d["neck_z"], "qc_sphere_resid": qc["sphere_resid_mm"],
               "qc_canal_fit_rms": qc["canal_fit_rms_mm"]},
        "deg": {"retroversion": d["retroversion_deg"],
                "neckshaft": d["neckshaft_deg"]},
        "unit": {"anp_plane_normal": d["anp_plane_normal_ct"]},
        "frac": {"qc_rf_pos_frac": qc["rf_pos_frac"],
                 "qc_mask_area_frac": qc["mask_area_frac"]},
        "exact": {"side": d["side"],
                  "qc_slice_overflow": bool(qc["slice_band_overflow"]),
                  "qc_peak_overflow": bool(qc["peak_capacity_overflow"]),
                  "qc_open_edges": bool(qc["open_edges"])},
    }


def cohort_row(lm, i: int, name: str) -> dict:
    """The reference's counterpart of one process_cohort dict, from bone
    i of its Landmarks batch (the cohort's SUMMARY_FIELDS, read as
    float32 and widened, as the cohort reads them)."""
    def f(x):
        return np.asarray(_row(x, i), np.float32).astype(np.float64)

    return {
        "name": name,
        "side": "left" if bool(_row(lm.side_is_left, i)) else "right",
        "retroversion_deg": float(f(lm.retroversion)),
        "neckshaft_deg": float(f(lm.neckshaft)),
        "radius_curvature_mm": float(f(lm.radius_curvature)),
        "neck_z": float(f(lm.neck_z)),
        "canal_axis_ct": f(lm.canal_axis), "te_axis_ct": f(lm.te_axis),
        "bg_axis_ct": f(lm.bg_axis),
        "anp_plane_point_ct": f(lm.anp_plane_point),
        "anp_plane_normal_ct": f(lm.anp_plane_normal),
        "qc": {"rf_pos_frac": float(f(lm.qc_rf_pos_frac)),
               "mask_area_frac": float(f(lm.qc_mask_area_frac)),
               "sphere_resid_mm": float(f(lm.qc_sphere_resid)),
               "canal_fit_rms_mm": float(f(lm.qc_canal_fit_rms)),
               "slice_band_overflow": bool(_row(lm.qc_slice_overflow, i)),
               "peak_capacity_overflow": bool(_row(lm.qc_peak_overflow, i)),
               "open_edges": bool(_row(lm.qc_open_edges, i))},
    }


def from_facade(r: dict) -> dict:
    """One request's reads of the Humerus facade (loops/facade.py)."""
    t = np.asarray(r["csys"], np.float64)
    return {
        "mm": {"radius_curvature": r["radius_curvature"],
               "canal_axis": r["canal_axis"], "bg_axis": r["bg_axis"],
               "te_axis": r["te_axis"], "anp_points": r["anp_points"],
               "anp_axis_normal": r["anp_axis_normal"],
               "sn_points": r["sn_points"], "csys_translation": t[:3, 3]},
        "deg": {"retroversion": r["retroversion"],
                "neckshaft": r["neckshaft"]},
        "unit": {"csys_axes": t[:3, :3]},
        "exact": {"side": r["side"]},
    }
