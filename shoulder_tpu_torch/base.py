"""Facade base abstractions: Landmark, Bone, Transform, Plane (numpy).

A copy of shoulder_tpu/base.py: landmarks cache CT-frame values and
re-project through a shared mutable 4x4 Transform on every read.
"""

from __future__ import annotations

import typing
from abc import ABC, abstractmethod

import numpy as np


class Transform:
    """Mutable 4x4 transform shared by a bone's landmarks
    (reference base.py:45-63)."""

    def __init__(self, matrix: np.ndarray | None = None):
        self._matrix = np.identity(4) if matrix is None else matrix

    @property
    def matrix(self) -> np.ndarray:
        return self._matrix

    @matrix.setter
    def matrix(self, new_matrix):
        new_matrix = np.asarray(new_matrix)
        if new_matrix.shape != (4, 4):
            raise ValueError(
                f"transform must be a 4x4 matrix, got shape {new_matrix.shape}"
            )
        self._matrix = new_matrix

    def reset(self) -> None:
        self._matrix = np.identity(4)


class Plane:
    """A plane as (point, normal) — the skspatial.objects.Plane analog the
    reference passes around (anatomic_neck.py:146, arthroplasty.py:102)."""

    def __init__(self, point, normal):
        self.point = np.asarray(point, dtype=np.float64).copy()
        self.normal = np.asarray(normal, dtype=np.float64).copy()

    def copy(self) -> "Plane":
        return Plane(self.point, self.normal)

    def __repr__(self):
        return f"Plane(point={self.point}, normal={self.normal})"


class Landmark(ABC):
    """A landmark view: cached CT values + current-frame projections
    (reference base.py:9-16)."""

    @abstractmethod
    def transform_landmark(self) -> None:
        """Refresh current-frame values after the shared Transform changed."""

    @abstractmethod
    def _graph_obj(self):
        """Plot trace(s) for this landmark, or None if not yet computed."""


class Bone(ABC):
    """Base bone facade: landmark discovery + bulk re-projection
    (reference base.py:19-42)."""

    stl_file: typing.Any
    transform: np.ndarray

    def _list_landmarks(self) -> typing.List[Landmark]:
        out = []
        for name in dir(self):
            if name.startswith("__"):
                continue
            attr = getattr(self, name)
            if isinstance(attr, Landmark):
                out.append(attr)
        return out

    def _update_landmark_data(self) -> None:
        for lm in self._list_landmarks():
            lm.transform_landmark()

    def _list_landmarks_graph_obj(self) -> list:
        objs = []
        for lm in self._list_landmarks():
            g = lm._graph_obj()
            if g is not None:
                objs.append(g)
        return objs
