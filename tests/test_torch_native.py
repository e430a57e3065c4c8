"""The port's native host ingest (shoulder_tpu_torch/io/native.py,
csrc/ingest.cpp, csrc/obb.cpp) against the JAX package's native path and
the port's numpy oracle.

Every comparison is exact, byte for byte (so -0.0 and +0.0 differ), unless
it says otherwise.  The native library is built by g++ from the port's
sources under its file lock; the JAX package's is built once per process
under test_torch_host's lock.
"""

import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shoulder_tpu.host import obb as jobb
from shoulder_tpu.io import ingest as jingest
from shoulder_tpu.io import native as jnative
from shoulder_tpu.io import stl as jstl
from shoulder_tpu_torch.host import obb
from shoulder_tpu_torch.io import ingest, native, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.ops import marching_tets
from shoulder_tpu_torch.pipeline import ct

from test_torch_ct import COARSE
from test_torch_host import _build_native_ingest_once

ROOT = Path(__file__).resolve().parents[1]
# left, right and proximal-only bones, each in its own random frame
BONES = {"left": dict(side="left", seed=11),
         "right": dict(side="right", seed=12),
         "proximal": dict(side="left", seed=13, proximal_only=True)}
EDGE_CASES = ("hole", "degenerate", "non_manifold", "signed_zero")


def _same(a, b):
    """Equal dtype, shape and bytes (-0.0 is not +0.0)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _assert_same_mesh(got, want):
    names = ("vertices", "faces", "neighbors", "watertight")
    for name, g, w in zip(names, got, want):
        assert _same(g, w), name


def _octahedron(subdiv=2):
    """A closed sphere-like mesh from a subdivided octahedron: a third of
    its vertices lie on the coordinate planes, so many coordinates are 0."""
    v = [np.array(p, float) for p in ((1, 0, 0), (-1, 0, 0), (0, 1, 0),
                                      (0, -1, 0), (0, 0, 1), (0, 0, -1))]
    f = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
         (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(subdiv):
        mid, nf = {}, []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (v[a] + v[b]) / 2.0
                v.append(m / np.linalg.norm(m))
                mid[key] = len(v) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        f = nf
    return 10.0 * np.array(v), np.array(f)


def _edge_soup(case):
    """(n, 3, 3) float32 triangles of a hand-made mesh."""
    v, f = _octahedron()
    tri = v[f].astype(np.float32)
    if case == "closed":
        return tri
    if case == "hole":
        return np.delete(tri, [5, 17], axis=0)
    if case == "degenerate":
        a, b = tri[0, 0], tri[0, 1]
        return np.concatenate([tri, [[a, a, b], [b, b, b], [a, b, a]]])
    if case == "non_manifold":
        # fins on two edges: one edge gets three faces, the other four
        fins = [[tri[0, 0], tri[0, 1], [20.0, 20.0, 0.0]],
                [tri[9, 1], tri[9, 2], [-20.0, 3.0, 1.0]],
                [tri[9, 1], tri[9, 2], [-21.0, -3.0, 2.0]]]
        return np.concatenate([tri, np.asarray(fins, np.float32)])
    assert case == "signed_zero"
    rng = np.random.default_rng(3)
    zero = tri == 0.0
    assert zero.sum() > 50
    tri[zero & (rng.random(tri.shape) < 0.5)] = -0.0
    return tri


def _write_soup(path, tri):
    n = tri.shape[0]
    stl.write_stl(path, tri.reshape(-1, 3), np.arange(3 * n).reshape(n, 3))
    return path


@pytest.fixture(scope="module")
def stls(tmp_path_factory):
    _build_native_ingest_once()
    d = tmp_path_factory.mktemp("native")
    out = {}
    for name, kw in BONES.items():
        kw = dict(kw)
        v, f = synthetic_humerus(
            rng_transform=np.random.default_rng(kw.pop("seed")), **kw)
        out[name] = d / f"{name}.stl"
        stl.write_stl(out[name], v, f)
    for case in EDGE_CASES:
        out[case] = _write_soup(d / f"{case}.stl", _edge_soup(case))
    return out


def _jax_numpy_indexed(path):
    tri = jstl.read_stl(path)
    verts, faces = jstl.weld(tri)
    return (verts, faces, *jstl.edge_face_adjacency(faces))


@pytest.mark.parametrize("name", [*BONES, *EDGE_CASES])
def test_load_indexed_matches_jax_native(stls, name):
    assert jnative.available()
    before = native.ingest_count
    got = stl.load_indexed(stls[name], warn_not_watertight=False)
    assert native.ingest_count == before + 1
    _assert_same_mesh(got, jnative.load_indexed(stls[name]))


@pytest.mark.parametrize("name", [*BONES, "hole", "degenerate"])
def test_load_indexed_matches_numpy(stls, name):
    got = stl.load_indexed(stls[name], warn_not_watertight=False)
    want = stl.load_indexed_numpy(stls[name], warn_not_watertight=False)
    _assert_same_mesh(got, want)
    _assert_same_mesh(want, _jax_numpy_indexed(stls[name]))
    assert got[3] == (name != "hole")


def test_native_stl_differs_from_numpy_as_the_jax_package_does(stls):
    """The STL entry keeps the JAX package's native semantics where its
    numpy path differs: (a) -0.0 and +0.0 weld to two vertices (the numpy
    weld merges them), (b) an edge with three or four faces keeps its
    first two paired (numpy pairs none of them)."""
    for case in ("signed_zero", "non_manifold"):
        got = stl.load_indexed(stls[case], warn_not_watertight=False)
        want = stl.load_indexed_numpy(stls[case], warn_not_watertight=False)
        _assert_same_mesh(want, _jax_numpy_indexed(stls[case]))
        _assert_same_mesh(got, jnative.load_indexed(stls[case]))
        assert not got[3] and want[3] == (case == "signed_zero")
        if case == "signed_zero":
            # numpy: the closed mesh, some zeros keeping a minus sign
            closed = stl.load_indexed_numpy(_write_soup(
                stls[case].with_name("closed.stl"), _edge_soup("closed")))
            assert np.array_equal(want[0], closed[0])
            assert np.signbit(want[0]).any()
            assert all(_same(w, c) for w, c in zip(want[1:], closed[1:]))
            assert got[0].shape[0] > want[0].shape[0]
        else:
            assert _same(got[0], want[0]) and _same(got[1], want[1])
            differs = (got[2] != want[2]).any(axis=1)
            assert differs.sum() == 4
            assert (want[2][differs] == -1).any(axis=1).all()


def test_ascii_stl_reads_through_numpy(tmp_path):
    v, f = _octahedron(1)
    lines = ["solid octa"]
    for tri in v[f]:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += ["vertex " + " ".join(map(repr, map(float, p)))
                  for p in tri]
        lines += ["endloop", "endfacet"]
    path = tmp_path / "octa.stl"
    path.write_text("\n".join(lines + ["endsolid octa"]))
    before = native.ingest_count
    got = stl.load_indexed(path)
    assert native.ingest_count == before
    _assert_same_mesh(got, jstl.load_indexed(path))
    assert got[3]


def test_truncated_stl_raises_like_numpy(stls, tmp_path):
    path = tmp_path / "cut.stl"
    path.write_bytes(stls["hole"].read_bytes()[:-7])
    for load in (stl.load_indexed, stl.load_indexed_numpy):
        with pytest.raises(ValueError, match="truncated"):
            load(path)


@pytest.mark.parametrize("name", ["left", "right"])
def test_obb_search_matches_jax_native(stls, name):
    verts = stl.load_indexed(stls[name])[0]
    hull, hp, normals = obb._hull(verts)
    before = native.obb_count
    got = obb.search_native(hp, normals, hull)
    assert native.obb_count == before + 1
    want = jobb._native_search(hp, normals, hull=hull)
    plain = native.min_volume_box(hp, normals)
    oracle = obb.search_numpy(hp, normals)
    for g, p, w, n in zip(got, plain, want, oracle):
        assert _same(g, w) and _same(p, w)
        assert np.abs(g - n).max() < 1e-6
    to_obb, extents = obb.oriented_bounds(verts)
    ref = jobb.oriented_bounds(verts)
    assert _same(to_obb, ref[0]) and _same(extents, ref[1])
    for g, n in zip((to_obb, extents), obb._to_obb(*oracle)):
        assert np.abs(g - n).max() < 1e-6


def test_oriented_bounds_numpy_agrees_on_a_point_cloud():
    pts = np.random.default_rng(4).normal(size=(400, 3)) * [3.0, 7.0, 20.0]
    got, want = obb.oriented_bounds(pts), obb.oriented_bounds_numpy(pts)
    assert np.abs(got[0] - want[0]).max() < 1e-6
    assert np.abs(got[1] - want[1]).max() < 1e-6
    assert np.all(np.diff(got[1]) > 0)


def test_obb_search_checks_its_inputs():
    hp = np.random.default_rng(0).normal(size=(10, 3))
    with pytest.raises(ValueError, match="outside"):
        native.min_volume_box_silhouette(hp, np.full((2, 3), 10), np.zeros(
            (2, 3)), np.ones((2, 3)), np.ones((1, 3)))
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        native.min_volume_box(hp[:, :2], np.ones((1, 3)))


@pytest.fixture(scope="module")
def coarse_soup():
    """tests/test_torch_ct.py's coarse CT volume, surfaced at HU 300 by
    the port's marching tets on the CPU."""
    vol, origin, spacing = ct.synth_ct_volume(**COARSE)
    soup = marching_tets.marching_tets(
        torch.as_tensor(vol), 300.0, tuple(map(float, origin)),
        tuple(map(float, spacing)))
    return soup.triangles[:int(soup.count)].numpy()


@pytest.mark.parametrize("case", ["coarse_ct", *EDGE_CASES])
def test_weld_soup_matches_numpy_weld(case, coarse_soup):
    tri = coarse_soup if case == "coarse_ct" else _edge_soup(case)
    before = native.ingest_count
    got = native.weld_soup(tri)
    assert native.ingest_count == before + 1
    verts, faces = jstl.weld(tri.astype(np.float64))
    _assert_same_mesh(got, (verts, faces, *jstl.edge_face_adjacency(faces)))
    if case == "coarse_ct":
        assert got[3] and got[1].shape[0] > 10000
    if case == "signed_zero":
        # one vertex per value, keeping the first-seen sign
        assert np.signbit(got[0]).any() and got[3]


def test_weld_soup_takes_float32_triangles_only():
    tri = _edge_soup("hole")
    for bad in (tri.astype(np.float64), tri.reshape(-1, 9)):
        with pytest.raises(ValueError, match="float32"):
            native.weld_soup(bad)


def _assert_same_spec(got, want):
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, str):
            assert g == w
        else:
            assert _same(g, w), field.name


@pytest.mark.parametrize("name", list(BONES))
def test_load_bone_matches_jax_package(stls, name):
    proximal = name == "proximal"
    before = (native.ingest_count, native.obb_count)
    got = ingest.load_bone(stls[name], proximal=proximal)
    assert (native.ingest_count, native.obb_count) == (before[0] + 1,
                                                      before[1] + 1)
    _assert_same_spec(got, jingest.load_bone(stls[name], proximal=proximal))


@pytest.mark.parametrize("arthritic", [False, True])
def test_spec_from_arrays_matches_jax_package(arthritic):
    """An in-memory bone as the accuracy cohorts build it."""
    deg = dict(head_flattening=0.25, osteophyte_amp=1.5,
               surface_noise=0.4) if arthritic else {}
    v, f = synthetic_humerus(rng_transform=np.random.default_rng(21), **deg)
    nbr, wt = stl.edge_face_adjacency(f)
    args = ("b", v.astype(np.float32), f.astype(np.int32), nbr, wt)
    _assert_same_spec(ingest.spec_from_arrays(*args),
                      jingest.spec_from_arrays(*args))


_SECOND_PROCESS = """
import subprocess, sys
sys.path.insert(0, sys.argv[1])
run, compiled = subprocess.run, []
def spy(cmd, *a, **kw):
    if "-shared" in cmd:
        compiled.append(cmd)
    return run(cmd, *a, **kw)
subprocess.run = spy
from shoulder_tpu_torch.io import native
print(native.build(), len(compiled))
"""


def test_second_process_finds_the_built_library():
    so = native.build()
    stat = so.stat()
    out = subprocess.run([sys.executable, "-c", _SECOND_PROCESS, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert out == [str(so), "0"]
    assert so.stat().st_ino == stat.st_ino
    assert so.stat().st_mtime_ns == stat.st_mtime_ns


_BUILD_AND_CALL = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from pathlib import Path
from shoulder_tpu_torch.io import native
so = native.build(build_dir=Path(sys.argv[2]))
native._lib = None
native.build = lambda: so
tri = np.random.default_rng(0).random((20, 3, 3)).astype(np.float32)
print(so.name, len(native.weld_soup(tri)[0]))
"""


def test_processes_building_together_share_one_build(tmp_path):
    """Four processes reach the first build together: one compiles under
    the lock, the others wait and load the finished library."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_CALL,
                               str(ROOT), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert len({o for o, _ in outs}) == 1
    assert outs[0][0].split()[1] == "60"
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".lock", ".so"]


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(native.CSRC / name, src / name)
    with open(src / "ingest.cpp", "a") as fh:
        fh.write("\n#error deliberately broken\n")
    with pytest.raises(RuntimeError, match="deliberately broken"):
        native.build(src, tmp_path / "build")
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".lock"]


def test_build_key_covers_sources_flags_and_host(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(native.CSRC / name, src / name)
    key = native.build_key(src)
    assert key == native.build_key(native.CSRC)
    (src / "obb.cpp").write_text((src / "obb.cpp").read_text() + "\n")
    assert native.build_key(src) != key
    monkeypatch.setattr(native, "cpu_model", lambda: "another CPU")
    assert native.build_key(native.CSRC) != key
