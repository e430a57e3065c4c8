"""Lightweight host-side triangle mesh (numpy).

A copy of shoulder_tpu/io/mesh.py: the mesh the facade exposes
(`Bone.mesh`), sectioned and clipped by the osteotomy and drawn by the
plots.  Not a device type: bones on the device are BoneTensors.
"""

from __future__ import annotations

import numpy as np

from shoulder_tpu_torch.host import slicing_np
from shoulder_tpu_torch.io import stl as stl_io


class Mesh:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 neighbors: np.ndarray | None = None):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int64)
        self._neighbors = neighbors

    # -- trimesh-compatible surface ---------------------------------------
    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    @property
    def neighbors(self) -> np.ndarray:
        if self._neighbors is None:
            self._neighbors, _ = stl_io.edge_face_adjacency(self.faces)
        return self._neighbors

    def copy(self) -> "Mesh":
        return Mesh(self.vertices.copy(), self.faces.copy(), self._neighbors)

    def apply_transform(self, transform: np.ndarray) -> "Mesh":
        t = np.asarray(transform)
        self.vertices = self.vertices @ t[:3, :3].T + t[:3, 3]
        return self

    def section(self, plane_normal, plane_origin):
        """Ordered contour loops of the plane/mesh intersection.

        Returns a list of (N,3) point loops (analog of trimesh
        Path3D.discrete as consumed by arthroplasty.points,
        reference arthroplasty.py:69-78).
        """
        n = np.asarray(plane_normal, dtype=np.float64)
        n = n / np.linalg.norm(n)
        origin = np.asarray(plane_origin, dtype=np.float64)
        # rotate so the plane normal is +z, slice, rotate back
        helper = np.eye(3)[np.argmin(np.abs(n))]
        a = np.cross(helper, n)
        a /= np.linalg.norm(a)
        b = np.cross(n, a)
        rot = np.stack([a, b, n])  # world -> plane
        v_r = self.vertices @ rot.T
        z0 = origin @ n
        loops = slicing_np.cross_section(v_r, self.faces, self.neighbors, z0)
        out = []
        for l in loops:
            pts2 = l["points"]
            pts3 = np.c_[pts2, np.full(len(pts2), z0)] @ rot
            out.append(
                {"points": pts3, "area": l["area"], "centroid2d": l["centroid"]}
            )
        return out

    def slice_plane(self, plane_origin, plane_normal) -> "Mesh":
        """Keep the +normal side, clipping crossing triangles.

        Equivalent of trimesh.Trimesh.slice_plane (uncapped), used by the
        osteotomy's resect_mesh (reference arthroplasty.py:80-87).
        """
        n = np.asarray(plane_normal, dtype=np.float64)
        n = n / np.linalg.norm(n)
        origin = np.asarray(plane_origin, dtype=np.float64)
        d = self.vertices @ n - origin @ n
        fd = d[self.faces]                       # (F,3)
        keep_all = np.all(fd >= 0, axis=1)
        drop_all = np.all(fd <= 0, axis=1)
        crossing = ~keep_all & ~drop_all

        new_tris = [self.vertices[self.faces[keep_all]]]
        for fi in np.flatnonzero(crossing):
            tri = self.vertices[self.faces[fi]]
            td = fd[fi]
            poly = []
            for k in range(3):
                p0, p1 = tri[k], tri[(k + 1) % 3]
                d0, d1 = td[k], td[(k + 1) % 3]
                if d0 >= 0:
                    poly.append(p0)
                if (d0 > 0) != (d1 > 0) and d0 != d1:
                    t = d0 / (d0 - d1)
                    poly.append(p0 + t * (p1 - p0))
            if len(poly) == 3:
                new_tris.append(np.asarray(poly)[None])
            elif len(poly) == 4:
                p = np.asarray(poly)
                new_tris.append(np.stack([p[[0, 1, 2]], p[[0, 2, 3]]]))
        tris = np.concatenate(new_tris, axis=0)
        verts, faces = stl_io.weld(tris)
        return Mesh(verts, faces)

    def cap_boundaries(self) -> "Mesh":
        """Close open boundary loops with centroid fans (watertight output).

        Used to build capped partial bones (e.g. a proximal humerus cropped
        from a full one) — the open cut left by slice_plane becomes a flat
        cap, matching how segmented clinical scans terminate.
        """
        f = self.faces
        nb, _ = stl_io.edge_face_adjacency(f)
        # boundary directed edges: face edge slots with no neighbor
        edges = []
        for k in range(3):
            rows = np.flatnonzero(nb[:, k] < 0)
            u = f[rows, k]
            v = f[rows, (k + 1) % 3]
            edges.extend(zip(u.tolist(), v.tolist()))
        if not edges:
            return self
        nxt = dict(edges)  # boundary is 1-manifold: u -> v
        new_tris = []
        verts = self.vertices
        remaining = dict(nxt)
        while remaining:
            start = next(iter(remaining))
            loop = [start]
            cur = remaining.pop(start)
            while cur != start and cur in remaining:
                loop.append(cur)
                cur = remaining.pop(cur)
            if len(loop) >= 3:
                centroid = verts[loop].mean(axis=0)
                for a, b in zip(loop, loop[1:] + loop[:1]):
                    # boundary edges run CCW on the open rim; fan wound
                    # (centroid, b, a) keeps outward orientation
                    new_tris.append(
                        np.stack([centroid, verts[b], verts[a]])
                    )
        if not new_tris:
            return self
        all_tris = np.concatenate(
            [verts[f], np.stack(new_tris)], axis=0
        )
        v2, f2 = stl_io.weld(all_tris)
        return Mesh(v2, f2)

    def export(self, path) -> None:
        stl_io.write_stl(path, self.vertices, self.faces)
