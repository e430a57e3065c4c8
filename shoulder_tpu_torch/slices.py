"""Slice-set facade: per-slice accessors over one contour stack (PyTorch).

Port of shoulder_tpu/slices.py.  A SliceSet is one family of cross
sections of a bone in the OBB frame, computed on first access by one
`ops.slicing.slice_stack` on the bone's device (on the card: one launch
of the slice-stack kernel) and read back to numpy float64.  The accessors take a
fractional cutoff window and keep the JAX package's array layout
((S, 2, N): row 0 = x|theta, row 1 = y|r) and both of its quirks: `itr`
returns cartesian data, and `itr_start_even_theta` returns `itr_start`.
"""

from __future__ import annotations

import numpy as np
import torch

from shoulder_tpu_torch.config import (DEFAULT_CONFIG, PipelineConfig,
                                       SliceSetConfig)
from shoulder_tpu_torch.ops import slicing


def _cutoff_idx(n: int, cutoff) -> tuple:
    return int((1 - cutoff[1]) * n), int((1 - cutoff[0]) * n)


class SliceSet:
    """Computed cross-section family of one bone in the OBB frame."""

    def __init__(self, spec, family: SliceSetConfig, z_top: float,
                 z_bottom: float, config: PipelineConfig = DEFAULT_CONFIG,
                 device="cuda"):
        self._spec = spec
        self._family = family
        self._z_top = z_top
        self._z_bottom = z_bottom
        self._cfg = config
        self._device = torch.device(device)
        self._stack = None

    def _compute(self):
        if self._stack is None:
            spec, dev = self._spec, self._device
            zs = np.linspace(self._z_top, self._z_bottom,
                             self._family.zslice_num).astype(np.float32)
            obb = torch.as_tensor(spec.obb_transform, dtype=torch.float32,
                                  device=dev)
            verts = torch.as_tensor(spec.vertices, dtype=torch.float32,
                                    device=dev)
            sg = slicing.sorted_geom(
                verts @ obb[:3, :3].T + obb[:3, 3],
                torch.as_tensor(spec.faces, device=dev),
                torch.as_tensor(spec.neighbors, device=dev),
                torch.as_tensor(spec.face_orig, device=dev),
            )
            st = slicing.slice_stack(sg, torch.as_tensor(zs, device=dev),
                                     self._family.interp_num,
                                     self._family.band,
                                     self._cfg.slice_compact_k)
            self._stack = {
                name: getattr(st, name).cpu().numpy().astype(np.float64)
                for name in ("contours", "centroids", "areas", "zs")
            }
        return self._stack

    def _cut(self, arr, cutoff):
        s, e = _cutoff_idx(arr.shape[0], cutoff)
        return arr[s:e]

    # ------------------------------------------------------- accessors
    def zs(self, cutoff) -> np.ndarray:
        return self._cut(self._compute()["zs"], cutoff)

    def areas1(self, cutoff) -> np.ndarray:
        """Largest-polygon area per slice."""
        return self._cut(self._compute()["areas"], cutoff)

    def centroids(self, cutoff) -> np.ndarray:
        return self._cut(self._compute()["centroids"], cutoff)

    def ixy(self, cutoff) -> np.ndarray:
        """(S, 2, N) resampled contours."""
        c = self._cut(self._compute()["contours"], cutoff)
        return np.transpose(c, (0, 2, 1))

    def ixy_centered(self, cutoff) -> np.ndarray:
        c = self._cut(self._compute()["contours"], cutoff)
        cen = self._cut(self._compute()["centroids"], cutoff)
        return np.transpose(c - cen[:, None, :], (0, 2, 1))

    def _pol(self, xy_s2n, sort: bool, roll_min: bool) -> np.ndarray:
        theta = np.arctan2(xy_s2n[:, 1], xy_s2n[:, 0])   # (S, N)
        r = np.hypot(xy_s2n[:, 0], xy_s2n[:, 1])
        if sort:
            order = np.argsort(theta, axis=1)
            theta = np.take_along_axis(theta, order, axis=1)
            r = np.take_along_axis(r, order, axis=1)
        elif roll_min:
            # roll each row so its min-theta sample leads
            n = theta.shape[1]
            k = np.argmin(theta, axis=1)[:, None]
            idx = (k + np.arange(n)[None, :]) % n
            theta = np.take_along_axis(theta, idx, axis=1)
            r = np.take_along_axis(r, idx, axis=1)
        return np.stack([theta, r], axis=1)

    def slices(self, cutoff) -> list:
        """Per-slice resampled largest-loop points, one (N, 2) array per
        slice."""
        c = self._cut(self._compute()["contours"], cutoff)
        return [np.asarray(p) for p in c]

    def itr(self, cutoff) -> np.ndarray:
        """Quirk kept from the JAX package: returns CARTESIAN data."""
        return self.ixy(cutoff)

    def itr_centered(self, cutoff) -> np.ndarray:
        return self._pol(self.ixy_centered(cutoff), sort=True, roll_min=False)

    def itr_start(self, cutoff) -> np.ndarray:
        return self._pol(self.ixy(cutoff), sort=False, roll_min=True)

    def itr_centered_start(self, cutoff) -> np.ndarray:
        return self._pol(self.ixy_centered(cutoff), sort=False, roll_min=True)

    def itr_start_even_theta(self, cutoff) -> np.ndarray:
        """Quirk kept from the JAX package: returns itr_start."""
        return self.itr_start(cutoff)


def full_slices(spec, config: PipelineConfig = DEFAULT_CONFIG,
                device="cuda") -> SliceSet:
    z_min, z_max = spec.z_bounds
    return SliceSet(spec, config.full, config.z_inset * z_max,
                    config.z_inset * z_min, config, device)


def distal_slices(spec, config: PipelineConfig = DEFAULT_CONFIG,
                  device="cuda") -> SliceSet:
    z_min, _ = spec.z_bounds
    return SliceSet(spec, config.distal, config.z_inset * z_min, 0.0, config,
                    device)


def proximal_slices(spec, neck_z: float,
                    config: PipelineConfig = DEFAULT_CONFIG,
                    device="cuda") -> SliceSet:
    _, z_max = spec.z_bounds
    return SliceSet(spec, config.proximal, config.z_inset * z_max, neck_z,
                    config, device)
