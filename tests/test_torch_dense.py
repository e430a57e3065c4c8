"""Meshes denser than DEFAULT_CONFIG's padding through the port's entry
points: the size rule (`config.by_size`), each entry point's `config=None`
at the padding its mesh takes, the `ingest.dense` counter, and
DENSE_CONFIG held to the benchmark's CT and dense configurations.

The entry points run on the CPU with the two-step ladder
(`config.PADDINGS`) replaced by `tiny_config()` and a tiny dense variant
(larger padding, k and bands), so a 96 x 64 mesh (12,288 faces) is past
the first step as a ~250k-face mesh is past DEFAULT_CONFIG.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from shoulder_tpu_torch import bone, cohort
from shoulder_tpu_torch import config as config_mod
from shoulder_tpu_torch.config import (DEFAULT_CONFIG, DENSE_CONFIG,
                                       SliceSetConfig, tiny_config)
from shoulder_tpu_torch.io import ingest, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.pipeline import batch as B
from shoulder_tpu_torch.pipeline import ct
from shoulder_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
TINY = tiny_config()
# tiny_config's stacks with the padding, k and chain of a ~28k-face mesh
# (tests/test_torch_ct.py) and wider windows
TINY_DENSE = dataclasses.replace(
    tiny_config(max_faces=32768, max_verts=16384), max_chain=1024,
    slice_compact_k=1024,
    **{name: SliceSetConfig(zslice_num=s, interp_num=n, band=2048)
       for name, (s, n) in (("full", (64, 64)), ("proximal", (96, 128)),
                            ("distal", (48, 96)))})
# (rings, sectors): 5,760 faces fit TINY, 12,288 faces need TINY_DENSE
SPARSE, DENSE = (60, 48), (96, 64)
# tests/test_ct_path.py's bone at 3 mm: a ~28k-face mesh
CT_BONE = dict(shape=(107, 48, 48), spacing=(3.0, 3.0, 3.0), seed=1,
               noise_hu=15.0, head_radius=26.0, shaft_radius=10.0,
               metaphysis_scale=0.6, groove_depth=4.5, groove_width_deg=20.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_ladder():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config_mod, "PADDINGS", (TINY, TINY_DENSE))
        yield


@pytest.fixture(autouse=True)
def clean_counters():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """STL files: sparse, dense, sparse (sides alternate), then a dense
    proximal humerus."""
    d = tmp_path_factory.mktemp("dense")
    out = []
    for i, (rings, sectors) in enumerate((SPARSE, DENSE, SPARSE, DENSE)):
        v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                 n_rings=rings, n_theta=sectors,
                                 proximal_only=i == 3,
                                 rng_transform=np.random.default_rng(40 + i))
        out.append(d / f"bone{i}.stl")
        stl.write_stl(out[-1], v, f)
    return out


# ------------------------------------------------------------ size rule
RULE_CASES = {
    # name: (faces, vertices, named config, the config or the error)
    "fits_default": (40960, 24576, None, DEFAULT_CONFIG),
    "faces_over_default": (245760, 122882, None, DENSE_CONFIG),
    "verts_over_default": (40000, 24577, None, DENSE_CONFIG),
    "over_every_padding": (300001, 122882, None,
                           "mesh of 300001 faces / 122882 verts exceeds every "
                           "padding (40960 faces / 24576 verts, 300000 faces "
                           "/ 160000 verts)"),
    "named_kept": (3000, 1500, DENSE_CONFIG, DENSE_CONFIG),
    "named_raises": (40961, 24000, DEFAULT_CONFIG,
                     "mesh exceeds configured padding"),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_size_rule(case):
    """The first padding that holds the mesh, raising past the last with
    both paddings and the mesh's counts named; a config the caller names
    is used as it is, and raises when the mesh is too big.  Through
    spec_from_arrays, at the mesh's counts (a small bone with repeats of
    its last vertex and degenerate faces added)."""
    n_faces, n_verts, named, want = RULE_CASES[case]
    if named is None:
        if isinstance(want, str):
            with pytest.raises(ValueError) as err:
                config_mod.by_size(n_faces, n_verts)
            assert str(err.value) == want
        else:
            assert config_mod.by_size(n_faces, n_verts) is want
        assert trace.counter("ingest.dense") == int(want is DENSE_CONFIG)
        trace.reset()
        if n_faces > 50000:
            return
    v, f = synthetic_humerus(n_rings=40, n_theta=32)
    verts = np.concatenate([v, np.repeat(v[-1:], n_verts - len(v), 0)])
    faces = np.concatenate([f, np.zeros((n_faces - len(f), 3), f.dtype)])
    nb, wt = stl.edge_face_adjacency(faces)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            ingest.spec_from_arrays("x", verts, faces, nb, wt, config=named)
        return
    spec = ingest.spec_from_arrays("x", verts, faces, nb, wt, config=named)
    assert spec.config is want
    assert spec.faces.shape == (want.max_faces, 3)
    assert spec.vertices.shape == (want.max_verts, 3)
    dense = named is None and want is not DEFAULT_CONFIG
    assert trace.counter("ingest.dense") == int(dense)


def test_dense_config_is_the_benchmarks():
    """DENSE_CONFIG is the `pipeline` of the CT cell's and of the dense
    mesh cell's configuration files, field for field."""
    from benchmark.harness import spec as S

    for name in ("ct_unet", "mesh_unet_dense"):
        conf = json.loads((ROOT / "benchmark" / "configs" /
                           f"{name}.json").read_text())
        assert S.pipeline_config(conf, DEFAULT_CONFIG) == DENSE_CONFIG, name
    assert config_mod.PADDINGS == (DEFAULT_CONFIG, DENSE_CONFIG)


# --------------------------------------------------------- entry points
def _same(got, want):
    """Two landmark dicts of the facade equal bit for bit."""
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _same(got[k], want[k])
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


FACADE_CASES = {"dense": (1, bone.Humerus, TINY_DENSE),
                "sparse": (0, bone.Humerus, TINY),
                "dense_proximal": (3, bone.ProximalHumerus, TINY_DENSE)}


@pytest.mark.parametrize("case", list(FACADE_CASES))
def test_facade_pads_by_size(tiny_ladder, paths, case):
    """Without a config the facade runs at the padding its mesh takes (a
    dense bone counts once in ingest.dense); the dense humerus's
    landmarks bit for bit its run with that config named."""
    which, cls, want_cfg = FACADE_CASES[case]
    got = cls(paths[which], device="cpu")
    assert got._spec.config is want_cfg and got._cfg is want_cfg
    assert trace.counter("ingest.dense") == int(want_cfg is TINY_DENSE)
    if case == "dense":
        want = cls(paths[which], config=want_cfg, device="cpu")
        _same(got._landmarks(), want._landmarks())


def test_cohort_pads_each_batch_by_size(tiny_ladder, paths):
    """Batches of 2 over sparse, dense, sparse: the first chunk runs as
    two batches, one a padding; rows in input order.  The dense row is bit
    for bit its run with its config named, and the sparse rows are bit
    for bit those of the cohort of the sparse bones alone: a bone's row
    does not depend on the sizes of its batch-mates."""
    got = cohort.process_cohort(paths[:3], batch_size=2, device="cpu")
    assert trace.counter("ingest.dense") == 1
    assert [r["name"] for r in got] == [p.stem for p in paths[:3]]
    sparse = cohort.process_cohort([paths[0], paths[2]], batch_size=2,
                                   device="cpu")
    (dense,) = cohort.process_cohort(paths[1:2], config=TINY_DENSE,
                                     batch_size=2, device="cpu")
    for g, w in zip(got, (sparse[0], dense, sparse[1])):
        _same(g, w)


def test_ct_path_pads_by_size(tiny_ladder):
    """volume_to_spec and landmarks_from_volume without a config: a 3 mm
    CT mesh (~28k faces) at the dense step, its landmarks bit for bit an
    explicit run's."""
    vol, origin, spacing = ct.synth_ct_volume(**CT_BONE)
    lm, spec = ct.landmarks_from_volume(vol, origin, spacing, device="cpu")
    assert spec.config is TINY_DENSE and spec.n_faces > TINY.max_faces
    assert trace.counter("ingest.dense") == 1
    want = B.landmarks_to_numpy(B.compute_landmarks_batch(
        B.stack_bones([spec], "cpu"), cfg=TINY_DENSE))
    for g, w in zip(lm, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
