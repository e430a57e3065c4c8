"""3D visualization of bones, landmarks, and osteotomies.

Port of shoulder_tpu/plotting.py (numpy): a Bone renders as mesh +
landmark traces, an osteotomy as the two resected meshes.  plotly is
optional: when installed, `.figure` is a real plotly Figure; otherwise a
lightweight Figure writes a standalone HTML file that loads plotly.js
from its CDN when opened.
"""

from __future__ import annotations

import json
import webbrowser
from pathlib import Path

import numpy as np

from shoulder_tpu_torch import arthroplasty, base
from shoulder_tpu_torch.io.mesh import Mesh

try:  # optional
    import plotly.graph_objects as go

    _HAS_PLOTLY = True
except ImportError:  # pragma: no cover
    go = None
    _HAS_PLOTLY = False

_BONE_COLOR = "#DFDAC0"

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<script src="https://cdn.plot.ly/plotly-2.32.0.min.js"></script>
</head><body>
<div id="plot" style="width:100vw;height:100vh;"></div>
<script>
Plotly.newPlot("plot", {data}, {layout});
</script>
</body></html>
"""


def mesh_trace(mesh: Mesh, opacity: float = 0.7) -> dict:
    v, f = mesh.vertices, mesh.faces
    return {
        "type": "mesh3d",
        "x": v[:, 0].tolist(), "y": v[:, 1].tolist(), "z": v[:, 2].tolist(),
        "i": f[:, 0].tolist(), "j": f[:, 1].tolist(), "k": f[:, 2].tolist(),
        "color": _BONE_COLOR,
        "opacity": opacity,
        "flatshading": False,
        "lighting": {
            "ambient": 0.18, "diffuse": 0.8, "fresnel": 0.1,
            "specular": 0.6, "roughness": 0.05,
            "facenormalsepsilon": 1e-15, "vertexnormalsepsilon": 1e-15,
        },
        "lightposition": {"x": 1000, "y": 1000, "z": -1000},
    }


class Figure:
    """Minimal plotly-compatible figure: trace dicts + layout."""

    def __init__(self, data: list, layout: dict):
        self.data = data
        self.layout = layout

    def update_layout(self, **kwargs):
        self.layout.update(kwargs)
        return self

    def to_html(self) -> str:
        def clean(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            raise TypeError(type(o))

        return _HTML_TEMPLATE.format(
            data=json.dumps(self.data, default=clean),
            layout=json.dumps(self.layout, default=clean),
        )

    def write_html(self, path) -> None:
        Path(path).write_text(self.to_html())

    def show(self) -> None:  # pragma: no cover
        out = Path("shoulder_tpu_plot.html").resolve()
        self.write_html(out)
        webbrowser.open(f"file://{out}")

    def to_plotly(self):
        if not _HAS_PLOTLY:  # pragma: no cover
            raise ImportError("plotly is not installed")
        return go.Figure(data=self.data, layout=self.layout)


class Plot:
    """Plot of a Bone (mesh + landmarks) or of a HumeralHeadOsteotomy
    (head + resected humerus)."""

    def __init__(self, obj2plot, opacity: float = 0.7):
        if isinstance(obj2plot, arthroplasty.HumeralHeadOsteotomy):
            data, name = self._surgery(obj2plot, opacity)
        elif isinstance(obj2plot, base.Bone):
            data, name = self._landmarks(obj2plot, opacity)
        else:
            raise ValueError(
                "Object to plot must be either a Bone or HumeralHeadOsteotomy"
            )
        layout = {
            "title": {"text": name},
            "scene": {"aspectmode": "data"},
        }
        self.figure = Figure(data, layout)
        if _HAS_PLOTLY:
            self.figure = self.figure.to_plotly()

    @staticmethod
    def _surgery(ost, opacity):
        head, rest = ost.resect_mesh()
        top = mesh_trace(head, opacity)
        bot = mesh_trace(rest, 1.0)
        return [top, bot], ost._humerus.stl_file.name

    @staticmethod
    def _landmarks(bone, opacity):
        data = [mesh_trace(bone.mesh, opacity)]
        for g in bone._list_landmarks_graph_obj():
            if isinstance(g, list):
                data.extend(g)
            else:
                data.append(g)
        return data, bone.stl_file.name
