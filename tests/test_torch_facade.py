"""The port's public API vs shoulder_tpu's, on the CPU at tiny_config.

`shoulder_tpu_torch.Humerus` (and the rest of the facade) runs here with
device="cpu" (the walk's plain version) on the same synthetic STL as
`shoulder_tpu.Humerus`; each test holds one part of the public surface
against the same JAX call.  One JAX and one port Humerus serve the whole
module: every test sets the frame it needs first.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest

import shoulder_tpu as jax_pkg
import shoulder_tpu_torch as torch_pkg
from shoulder_tpu import arthroplasty as j_arth
from shoulder_tpu import bone as j_bone
from shoulder_tpu import cohort as j_cohort
from shoulder_tpu import plotting as j_plot
from shoulder_tpu import slices as j_slices
from shoulder_tpu.config import tiny_config as jax_tiny_config
from shoulder_tpu.io.mesh import Mesh as JMesh
from shoulder_tpu_torch import arthroplasty as t_arth
from shoulder_tpu_torch import bone as t_bone
from shoulder_tpu_torch import cohort as t_cohort
from shoulder_tpu_torch import plotting as t_plot
from shoulder_tpu_torch import slices as t_slices
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.io import stl
from shoulder_tpu_torch.io.mesh import Mesh as TMesh
from shoulder_tpu_torch.io.testdata import synthetic_humerus

CUTOFF = (0.1, 0.9)


@pytest.fixture(scope="module")
def bone_path(tmp_path_factory):
    v, f = synthetic_humerus(rng_transform=np.random.default_rng(0),
                             n_rings=60, n_theta=48)
    p = tmp_path_factory.mktemp("facade") / "bone.stl"
    stl.write_stl(p, v, f)
    return p


@pytest.fixture(scope="module")
def hums(bone_path):
    """(JAX Humerus, port Humerus) of the same STL."""
    j = jax_pkg.Humerus(bone_path, config=jax_tiny_config())
    t = torch_pkg.Humerus(bone_path, config=tiny_config(), device="cpu")
    return j, t


# ------------------------------------------------------------ signatures
def _norm_default(d):
    if dataclasses.is_dataclass(d):
        return (type(d).__name__, dataclasses.asdict(d))
    return d


def _sig(fn, drop=()):
    sig = inspect.signature(fn)
    return [(p.name, p.kind, str(p.annotation), _norm_default(p.default))
            for p in sig.parameters.values() if p.name not in drop]


# the one allowed difference: the port's `device` keyword (the JAX
# package has no JAX-only keyword left: `device_mesh` came with the port's
# parallel/mesh.py)
_PORT_ONLY = ("device",)
_JAX_ONLY = ()

_CLASSES = [
    ("Canal", j_bone.Canal, t_bone.Canal),
    ("SurgicalNeck", j_bone.SurgicalNeck, t_bone.SurgicalNeck),
    ("DeepGroove", j_bone.DeepGroove, t_bone.DeepGroove),
    ("AnatomicNeck", j_bone.AnatomicNeck, t_bone.AnatomicNeck),
    ("TransEpicondylar", j_bone.TransEpicondylar, t_bone.TransEpicondylar),
    ("ProximalHumerus", j_bone.ProximalHumerus, t_bone.ProximalHumerus),
    ("Humerus", j_bone.Humerus, t_bone.Humerus),
    ("SliceSet", j_slices.SliceSet, t_slices.SliceSet),
    ("HumeralHeadOsteotomy", j_arth.HumeralHeadOsteotomy,
     t_arth.HumeralHeadOsteotomy),
    ("Plot", j_plot.Plot, t_plot.Plot),
]


@pytest.mark.parametrize("name,jcls,tcls", _CLASSES,
                         ids=[c[0] for c in _CLASSES])
def test_public_signatures_match(name, jcls, tcls):
    public = sorted(m for m in dir(jcls) if not m.startswith("_"))
    assert public == sorted(m for m in dir(tcls) if not m.startswith("_"))
    assert _sig(jcls) == _sig(tcls, drop=_PORT_ONLY), name
    for m in public:
        ja, ta = (inspect.getattr_static(jcls, m),
                  inspect.getattr_static(tcls, m))
        assert isinstance(ja, property) == isinstance(ta, property), m
        if callable(ja):
            assert _sig(ja) == _sig(ta), f"{name}.{m}"


def test_process_cohort_signature_matches():
    assert (_sig(j_cohort.process_cohort, drop=_JAX_ONLY)
            == _sig(t_cohort.process_cohort, drop=_PORT_ONLY))
    assert j_cohort.SUMMARY_FIELDS == t_cohort.SUMMARY_FIELDS


# ------------------------------------------------------------ quickstart
def test_quickstart_matches_jax(hums):
    """The README flow.  Measured gaps (this bone): transform 6e-8,
    canal / TE / groove axes 1.6e-5 / 2.1e-5 / 3.1e-5 mm, ANP rim
    2.6e-5 mm, neck-shaft 1.5e-5 deg, retroversion 1.1e-5 deg, radius
    under 1e-5 mm."""
    j, t = hums
    tj = j.apply_csys_canal_transepiconylar()
    tt = t.apply_csys_canal_transepiconylar()
    assert tt.shape == (4, 4)
    assert np.allclose(tt, tj, atol=1e-4)
    for view in ("canal", "trans_epiconylar", "bicipital_groove"):
        assert np.allclose(getattr(t, view).axis(), getattr(j, view).axis(),
                           atol=1e-2), view
    canal = t.canal.axis()
    d = (canal[0] - canal[1]) / np.linalg.norm(canal[0] - canal[1])
    assert np.allclose(np.abs(d), [0, 0, 1], atol=1e-4)
    assert np.allclose(canal.mean(0), 0, atol=1e-3)
    pa, pj = t.anatomic_neck.points(), j.anatomic_neck.points()
    assert pa.shape == pj.shape and len(pa) > 10
    assert np.allclose(pa, pj, atol=1e-2)
    assert t.side() == j.side()
    assert abs(t.neckshaft() - j.neckshaft()) < 0.75
    assert abs(t.retroversion() - j.retroversion()) < 0.75
    assert abs(t.radius_curvature() - j.radius_curvature()) < 0.75
    qt, qj = t.quality(), j.quality()
    assert qt.keys() == qj.keys()
    for k in ("slice_band_overflow", "peak_capacity_overflow", "open_edges"):
        assert qt[k] == qj[k], k


# ---------------------------------------------------------------- frames
def test_frames_match_jax(hums):
    j, t = hums
    for h in (j, t):
        h.apply_csys_ct()
    a0 = t.canal.axis().copy()
    assert np.allclose(a0, j.canal.axis(), atol=1e-4)
    t.apply_csys_canal_transepiconylar()
    assert not np.allclose(t.canal.axis(), a0)
    t.apply_csys_ct()
    assert np.allclose(t.canal.axis(), a0, atol=1e-4)
    # a custom csys from CT (as test_pipeline.test_facade_csys_roundtrip)
    q = np.random.default_rng(1).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    tf = np.eye(4)
    tf[:3, :3] = rot
    tf[:3, 3] = [5.0, -2.0, 1.0]
    out = [h.apply_csys_custom(tf) for h in (j, t)]
    assert np.allclose(out[1], out[0], atol=1e-4)
    assert np.allclose(t.canal.axis(), a0 @ rot.T + tf[:3, 3], atol=1e-4)
    out = [h.apply_translation([1.5, -0.5, 2.0]) for h in (j, t)]
    assert np.allclose(out[1], out[0], atol=1e-4)
    assert np.allclose(t.mesh.vertices, j.mesh.vertices, atol=1e-4)
    # get_transform uses the axis as last read, in the frame of that read
    assert np.allclose(t.canal.axis(), j.canal.axis(), atol=1e-4)
    assert np.allclose(t.canal.get_transform(), j.canal.get_transform(),
                       atol=1e-4)
    assert np.allclose(t.apply_csys_obb(), j.apply_csys_obb(), atol=1e-4)


# ------------------------------------------------------------- overrides
def test_parameter_overrides_match_jax_and_stick(bone_path):
    """Non-default canal and groove windows recompute the landmarks and
    stay in force across a later csys change, in both packages.  The JAX
    reference records both overrides up front, so it compiles its
    pipeline once; the public calls below then find them in force."""
    j = jax_pkg.Humerus(bone_path, config=jax_tiny_config())
    j._set_params(canal_cutoff=(0.45, 0.65), groove_deg_window=21.0)
    t = torch_pkg.Humerus(bone_path, config=tiny_config(), device="cpu")
    pj = j.canal.points(cutoff_pcts=(0.45, 0.65))
    pt = t.canal.points(cutoff_pcts=(0.45, 0.65))
    assert pt.shape == pj.shape and np.allclose(pt, pj, atol=1e-2)
    gj = j.bicipital_groove.points(deg_window=21)
    gt = t.bicipital_groove.points(deg_window=21)
    assert np.allclose(gt, gj, atol=1e-2)
    assert t._effective_cfg().canal_cutoff == (0.45, 0.65)
    assert t._effective_cfg().groove_deg_window == 21.0
    for h in (j, t):
        h.apply_csys_canal_articular()
    assert np.allclose(t.transform, j.transform, atol=1e-4)
    assert np.allclose(t.canal.points(), j.canal.points(), atol=1e-2)
    assert len(t.canal.points()) == len(pt)
    assert np.allclose(t.bicipital_groove.points(),
                       j.bicipital_groove.points(), atol=1e-2)
    assert t._effective_cfg().canal_cutoff == (0.45, 0.65)


# ------------------------------------------------------------- osteotomy
def test_osteotomy_matches_jax(hums):
    j, t = hums
    for h in (j, t):
        h.apply_csys_canal_transepiconylar()
    oj, ot = jax_pkg.HumeralHeadOsteotomy(j), torch_pkg.HumeralHeadOsteotomy(t)
    assert np.allclose(t.transform, j.transform, atol=1e-4)
    assert ot.neckshaft_rel == pytest.approx(0.0, abs=1e-4)
    assert ot.offset_neckshaft == ot.offest_neckshaft
    for o in (oj, ot):
        o.offest_neckshaft(5.0)
        o.offset_retroversion(4.0)
        o.offset_depth(2.0, "anp")
        o.offset_anterior_posterior(1.0)
    assert ot.neckshaft_rel == pytest.approx(oj.neckshaft_rel, abs=1e-4)
    assert ot.retroversion_rel == pytest.approx(oj.retroversion_rel, abs=1e-4)
    assert np.allclose(ot.plane.point, oj.plane.point, atol=1e-4)
    assert np.allclose(ot.plane.normal, oj.plane.normal, atol=1e-4)
    (hj, rj), (ht, rt) = oj.resect_mesh(), ot.resect_mesh()
    for a, b in ((ht, hj), (rt, rj)):
        assert abs(len(a.faces) - len(b.faces)) <= 0.005 * len(b.faces)
    assert len(ht.faces) > 50 and len(rt.faces) > 50
    assert np.allclose(ot.points(), oj.points(), atol=1e-2)
    with pytest.raises(ValueError):
        ot.offset_depth(1.0, "bogus")


# ---------------------------------------------------------- slice views
@pytest.mark.parametrize("family", ["full_slices", "proximal_slices",
                                    "distal_slices"])
def test_slice_views_match_jax(hums, family):
    """Contours 1e-3 and areas 0.01, the slice kernel's tolerances
    (tests/test_slice_kernel.py).  Measured: contours under 4e-5 mm,
    areas under 6e-4 mm^2, zs equal."""
    j, t = hums
    vj, vt = getattr(j, family), getattr(t, family)
    assert np.array_equal(vt.zs(CUTOFF), vj.zs(CUTOFF))
    assert np.allclose(vt.areas1(CUTOFF), vj.areas1(CUTOFF), atol=0.01)
    assert np.allclose(vt.centroids(CUTOFF), vj.centroids(CUTOFF), atol=1e-3)
    assert vt.ixy(CUTOFF).shape == vj.ixy(CUTOFF).shape
    assert np.allclose(vt.ixy(CUTOFF), vj.ixy(CUTOFF), atol=1e-3)
    assert np.allclose(vt.itr_centered_start(CUTOFF),
                       vj.itr_centered_start(CUTOFF), atol=1e-3)
    # the two quirks of the JAX package's accessors
    assert np.array_equal(vt.itr(CUTOFF), vt.ixy(CUTOFF))
    assert np.array_equal(vt.itr_start_even_theta(CUTOFF),
                          vt.itr_start(CUTOFF))


# --------------------------------------------------------- mesh and plot
def test_mesh_section_and_slice_plane_equal_jax(hums):
    j, _ = hums
    spec = j._spec
    mj = JMesh(spec.vertices_raw, spec.faces_raw)
    mt = TMesh(spec.vertices_raw, spec.faces_raw)
    normal, origin = np.array([0.2, -0.1, 1.0]), mj.vertices.mean(0)
    sj, st = mj.section(normal, origin), mt.section(normal, origin)
    assert len(sj) == len(st) > 0
    for a, b in zip(sj, st):
        assert np.array_equal(a["points"], b["points"])
        assert a["area"] == b["area"]
    cj, ct = mj.slice_plane(origin, normal), mt.slice_plane(origin, normal)
    assert np.array_equal(cj.vertices, ct.vertices)
    assert np.array_equal(cj.faces, ct.faces)


def _traces(fig):
    html = fig.to_html()
    start = html.index('Plotly.newPlot("plot", ') + len('Plotly.newPlot("plot", ')
    data, _ = json.JSONDecoder().raw_decode(html[start:])
    return [(d["type"], d.get("name")) for d in data]


def test_plot_lists_jax_traces(hums):
    j, t = hums
    for h in (j, t):
        h.apply_csys_canal_transepiconylar()
        h.canal.axis()
        h.anatomic_neck.points()
    got, want = _traces(torch_pkg.Plot(t).figure), _traces(jax_pkg.Plot(j).figure)
    assert got == want
    assert ("mesh3d", None) in got and ("scatter3d", "Canal Axis") in got
    oj, ot = jax_pkg.HumeralHeadOsteotomy(j), torch_pkg.HumeralHeadOsteotomy(t)
    assert _traces(torch_pkg.Plot(ot).figure) == _traces(jax_pkg.Plot(oj).figure)


# ---------------------------------------------------------- proximal bone
def test_proximal_humerus_matches_jax(tmp_path):
    v, f = synthetic_humerus(rng_transform=np.random.default_rng(3),
                             n_rings=60, n_theta=48, proximal_only=True)
    p = tmp_path / "prox.stl"
    stl.write_stl(p, v, f)
    j = jax_pkg.ProximalHumerus(p, config=jax_tiny_config())
    t = torch_pkg.ProximalHumerus(p, config=tiny_config(), device="cpu")
    assert not hasattr(t, "trans_epiconylar")
    assert not hasattr(t, "retroversion")
    assert t.side() == j.side()
    assert abs(t.neckshaft() - j.neckshaft()) < 0.75
    assert abs(t.radius_curvature() - j.radius_curvature()) < 0.75
    assert np.allclose(t.apply_csys_canal_articular(),
                       j.apply_csys_canal_articular(), atol=1e-4)


def test_validate_fills_cache_in_constructor(bone_path):
    j = jax_pkg.Humerus(bone_path, config=jax_tiny_config(), validate=True)
    t = torch_pkg.Humerus(bone_path, config=tiny_config(), validate=True,
                          device="cpu")
    assert t._lm_cache is not None and j._lm_cache is not None
    assert t.side() == j.side()
    lazy = torch_pkg.Humerus(bone_path, config=tiny_config(), device="cpu")
    assert lazy._lm_cache is None


def test_default_device_is_the_card(bone_path):
    """No CPU fallback: the default device is CUDA, and without a card
    the constructor raises."""
    import torch

    for cls in (t_bone.Humerus, t_bone.ProximalHumerus, t_slices.SliceSet,
                t_cohort.process_cohort):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            torch_pkg.Humerus(bone_path, config=tiny_config())
