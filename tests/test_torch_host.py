"""The port's host layer vs shoulder_tpu's, and the port's independence
from JAX.

The port carries its own copies of the host modules and of the native
ingest (the card's machine has no JAX, and importing anything under
shoulder_tpu imports jax), so its ingest must reproduce shoulder_tpu's
BoneSpec.
"""

import ast
import fcntl
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from shoulder_tpu.io import ingest as jax_ingest
from shoulder_tpu.io import stl
from shoulder_tpu.io.testdata import synthetic_humerus
from shoulder_tpu_torch.io import ingest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "shoulder_tpu"}


def _build_native_ingest_once():
    """Build the JAX package's native ingest library one process at a
    time, before this process runs any test.

    shoulder_tpu/io/native.py builds the library on its first use, with
    g++ writing the .so in place.  Under pytest-xdist several workers
    reach that first use together, and a worker that finds the file
    half-written fails to load it ("file too short"): every test of the
    module whose fixture ingested first then errors.  Each worker collects
    this module before it runs a test, so building here under an exclusive
    lock leaves every worker a finished library."""
    from shoulder_tpu.io import native

    lock = ROOT / "shoulder_tpu_torch" / "_build" / "native_ingest.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        native.available()


_build_native_ingest_once()


@pytest.mark.parametrize("side,proximal", [("left", False),
                                           ("right", False),
                                           ("left", True)])
def test_load_bone_matches_jax_package(tmp_path, side, proximal):
    v, f = synthetic_humerus(side=side, proximal_only=proximal,
                             rng_transform=np.random.default_rng(5))
    path = tmp_path / "bone.stl"
    stl.write_stl(path, v, f)
    ref = jax_ingest.load_bone(path, proximal=proximal)
    got = ingest.load_bone(path, proximal=proximal)
    for name in ("faces", "neighbors", "face_orig", "vertices"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name
    # both packages search the OBB in their own copy of the same native
    # code, built with the same flags: the same box, bit for bit
    assert np.array_equal(got.obb_transform, ref.obb_transform)
    assert np.array_equal(got.z_bounds, ref.z_bounds)
    assert np.array_equal(got.cutoff_pcts, ref.cutoff_pcts)
    assert (got.n_faces, got.n_verts) == (ref.n_faces, ref.n_verts)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "shoulder_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              ROOT / "bench_torch.py",
              ROOT / "tools" / "bench_cohort_torch.py",
              ROOT / "tools" / "make_unet_corpus_torch.py",
              ROOT / "tools" / "train_unet_torch.py",
              ROOT / "tools" / "grad_noise_torch.py",
              ROOT / "tools" / "profile_torch_batch.py",
              ROOT / "tools" / "round_once_torch.py",
              ROOT / "tools" / "arthritic_divergence_torch.py",
              ROOT / "tools" / "eval_ct_poses_torch.py",
              ROOT / "tools" / "eval_articular_torch.py",
              ROOT / "tools" / "eval_arthritic_ab_torch.py",
              ROOT / "tools" / "eval_accuracy_torch.py",
              ROOT / "tools" / "refresh_evidence_torch.py",
              ROOT / "tools" / "eval_ct_pitch_torch.py",
              ROOT / "tools" / "raw_loop_ab_torch.py",
              ROOT / "tools" / "sphere_kernels_torch.py",
              ROOT / "tools" / "phase6_torch.py",
              ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys, tempfile
from pathlib import Path
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "shoulder_tpu"):
    sys.modules[name] = None          # any import of them now raises
sys.path.insert(0, sys.argv[1])
import numpy as np
import shoulder_tpu_torch
for mod in pkgutil.walk_packages(shoulder_tpu_torch.__path__,
                                 "shoulder_tpu_torch."):
    importlib.import_module(mod.name)
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.io import ingest, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
v, f = synthetic_humerus(rng_transform=np.random.default_rng(1),
                         n_rings=40, n_theta=32)
with tempfile.TemporaryDirectory() as td:
    p = Path(td) / "b.stl"
    stl.write_stl(p, v, f)
    spec = ingest.load_bone(p, config=tiny_config())
    assert spec.face_orig is not None
    hum = shoulder_tpu_torch.Humerus(p, config=tiny_config(), device="cpu")
    side = hum.side()
assert side in ("left", "right")
from shoulder_tpu_torch.ops import marching_tets
from shoulder_tpu_torch.pipeline import ct
vol, _origin, _spacing = ct.synth_ct_volume(shape=(40, 24, 24),
                                            spacing=(8.0, 6.0, 6.0))
seg, iso = ct.segment_volume(vol, "unet", device="cpu")
assert int(marching_tets.marching_tets(seg, iso).count) > 0
# the training path: corpus tool, both trainers, checkpoint, serving
import importlib.util
import torch
from shoulder_tpu_torch.models import ct_unet, unet, unet_train
assert "shoulder_tpu_torch.models.unet_train" in sys.modules
tools = {}
for name in ("make_unet_corpus_torch", "train_unet_torch"):
    tspec = importlib.util.spec_from_file_location(
        name, Path(sys.argv[1]) / "tools" / (name + ".py"))
    tools[name] = importlib.util.module_from_spec(tspec)
    tspec.loader.exec_module(tools[name])
assert callable(tools["make_unet_corpus_torch"].build_corpus)
rng = np.random.default_rng(0)
corpus = (rng.random((4, 32, 32)).astype(np.float16),
          (rng.random((4, 32, 32)) > 0.5).astype(np.uint8))
model, losses = unet_train.train_mixture(
    *corpus, steps=2, batch=4, size=32, log_every=1, features=(4, 8),
    device="cpu")
ct_model, ct_losses = ct_unet.train(steps=1, size=(16, 16, 16), log_every=1,
                                    device="cpu")
assert np.isfinite(losses + ct_losses).all()
with tempfile.TemporaryDirectory() as td:
    unet_train.save_params(model, Path(td) / "u.npz")
    served = unet.load_model("cpu", Path(td) / "u.npz")
    mask = unet.segment_image(served, torch.as_tensor(corpus[0][0]).float())
assert mask.shape == (32, 32)
leaked = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "flax", "orbax", "shoulder_tpu") and sys.modules[m]]
assert not leaked, leaked
print("NO_JAX_OK", spec.n_faces, side)
"""


def test_port_runs_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT)],
                       capture_output=True, text=True, timeout=300)
    assert "NO_JAX_OK" in r.stdout, r.stderr[-3000:]
