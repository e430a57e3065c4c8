"""Humeral-head osteotomy planning (numpy over the facade).

Port of shoulder_tpu/arthroplasty.py: the resection plane lives in the
canal-articular (ANP) coordinate system, where version and neck-shaft
edits are spherical edits of the plane normal; reads re-project to the
bone's current frame.  The published API is kept, including the
`offest_neckshaft` spelling.  The spherical and inverse-transform math
runs in float32, as in the JAX facade (utils/geometry.host_f32).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from shoulder_tpu_torch import bone as bone_mod
from shoulder_tpu_torch.base import Plane
from shoulder_tpu_torch.io.mesh import Mesh
from shoulder_tpu_torch.utils import geometry as geom


def _np_inv(t):
    return geom.host_f32(geom.inv_transform, t)


def _transform_plane(plane: Plane, transform) -> Plane:
    t = np.asarray(transform)
    point = plane.point @ t[:3, :3].T + t[:3, 3]
    normal = t[:3, :3] @ plane.normal
    return Plane(point, normal)


def _spherical(xyz):
    return geom.host_f32(geom.unitxyz_to_spherical, xyz)


def _unspherical(sphr):
    return geom.host_f32(geom.spherical_to_unitxyz, sphr)


class HumeralHeadOsteotomy:
    """Resects the humeral head at (or offset from) the anatomic neck plane."""

    def __init__(self, humerus: bone_mod.ProximalHumerus) -> None:
        self._humerus = humerus
        self._caller_matrix = humerus._tfrm.matrix.copy()

        # capture the ANP plane in the canal-articular csys
        humerus.apply_csys_canal_articular()
        self._anp_frame_matrix = humerus._tfrm.matrix.copy()
        self._native_plane_anp = humerus.anatomic_neck.plane()
        self._cut_plane_anp = humerus.anatomic_neck.plane()

        # restore the caller's csys via CT
        humerus.apply_csys_ct()
        humerus.apply_csys_custom(self._caller_matrix)

    # ------------------------------------------------------------- reads
    @property
    def plane(self) -> Plane:
        """Resection plane in the current csys."""
        p = _transform_plane(self._cut_plane_anp, _np_inv(self._anp_frame_matrix))
        return _transform_plane(p, self._humerus._tfrm.matrix)

    @property
    def neckshaft_rel(self) -> float:
        """Neck-shaft angle of the cut relative to native."""
        ns = 180.0 - _spherical(self._cut_plane_anp.normal)[2]
        ns_og = 180.0 - _spherical(self._native_plane_anp.normal)[2]
        return float(ns - ns_og)

    @property
    def retroversion_rel(self) -> float:
        """Version of the cut relative to native."""
        an = self._cut_plane_anp.normal.copy()
        an[0] = -an[0]
        ret = _spherical(an)[1]
        if self._humerus.side() == "right":
            ret = -ret
        return float(ret)

    def points(self) -> np.ndarray:
        """Resection plane / mesh intersection contour (largest loop)."""
        pl = self.plane
        loops = self._humerus.mesh.section(pl.normal, pl.point)
        if not loops:
            return np.zeros((0, 3))
        best = max(loops, key=lambda l: l["area"])
        return best["points"]

    def resect_mesh(self) -> Tuple[Mesh, Mesh]:
        """(head, resected humerus) in the current csys."""
        pl = self.plane
        head = self._humerus.mesh.slice_plane(pl.point, pl.normal)
        rest = self._humerus.mesh.slice_plane(pl.point, -1 * pl.normal)
        return head, rest

    # ------------------------------------------------------------ offsets
    def offset_retroversion(self, deg: float) -> None:
        """Rotate the cut's version by `deg` (more retroversion > 0)."""
        sphr = _spherical(self._cut_plane_anp.normal)
        if self._humerus.side() == "left":
            # more retroversion = smaller theta on a left humerus
            sphr[1] -= deg
        else:
            sphr[1] += deg
        self._cut_plane_anp = Plane(
            self._cut_plane_anp.point, _unspherical(sphr)
        )

    def offest_neckshaft(self, deg: float) -> None:
        """Steepen the cut's neck-shaft angle by `deg` (published
        spelling)."""
        sphr = _spherical(self._cut_plane_anp.normal)
        sphr[2] -= deg  # a steeper neck-shaft cut lowers phi
        self._cut_plane_anp = Plane(
            self._cut_plane_anp.point, _unspherical(sphr)
        )

    # ergonomic alias
    offset_neckshaft = offest_neckshaft

    def offset_depth(self, mm: float, direction: str = "canal") -> None:
        """Shift the cut by `mm` along the canal, the native ANP normal or
        the cut's own normal."""
        new_point = self._cut_plane_anp.point.copy()
        if direction == "canal":
            new_point[2] += mm
        elif direction == "anp":
            new_point += mm * self._native_plane_anp.normal
        elif direction == "resection":
            new_point += mm * self._cut_plane_anp.normal
        else:
            raise ValueError(
                f"unknown offset direction {direction!r}; expected one of "
                "'canal', 'anp', 'resection'"
            )
        self._cut_plane_anp = Plane(
            new_point, self._cut_plane_anp.normal
        )

    def offset_anterior_posterior(self, mm: float) -> None:
        """Anterior(+) / posterior(-) shift."""
        new_point = self._cut_plane_anp.point.copy()
        if self._humerus.side() == "left":
            new_point[0] -= mm
        else:
            new_point[0] += mm
        self._cut_plane_anp = Plane(
            new_point, self._cut_plane_anp.normal
        )

    def offset_medial_lateral(self, mm: float) -> None:
        """Medial(+) / lateral(-) shift."""
        new_point = self._cut_plane_anp.point.copy()
        new_point[1] -= mm
        self._cut_plane_anp = Plane(
            new_point, self._cut_plane_anp.normal
        )
