"""The port's CT path (pipeline/ct.py, ops/marching_tets.py,
models/ct_unet.py) against the JAX package's, on the CPU at small sizes.

Tolerances: triangles and welded vertices within 1e-4 mm (XLA may fuse
the edge interpolation into a multiply-add, PyTorch's eager kernels do
not, so a coordinate can differ in its last bits); counts, weld sizes and
watertightness exactly; UNet logits within 0.02 of their range (both
convolve in bfloat16, rounding at different places) and masks by voxel
agreement; landmarks within bench.py's 0.75 deg / 0.75 mm gate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoulder_tpu.config import SliceSetConfig as JSliceSetConfig
from shoulder_tpu.config import tiny_config as jtiny_config
from shoulder_tpu.models import ct_unet as jct_unet
from shoulder_tpu.ops import marching_tets as jmt
from shoulder_tpu.pipeline import batch as JB
from shoulder_tpu.pipeline import ct as jct
from shoulder_tpu_torch.config import SliceSetConfig, tiny_config
from shoulder_tpu_torch.io import stl
from shoulder_tpu_torch.models import convert
from shoulder_tpu_torch.models import ct_unet
from shoulder_tpu_torch.ops import marching_tets
from shoulder_tpu_torch.pipeline import batch as TB
from shoulder_tpu_torch.pipeline import ct

TOL_MM = 1e-4
# tests/test_ct_path.py's bone: a pronounced surgical neck
BONE_KW = dict(head_radius=26.0, shaft_radius=10.0, metaphysis_scale=0.6,
               groove_depth=4.5, groove_width_deg=20.0)
COARSE = dict(shape=(107, 48, 48), spacing=(3.0, 3.0, 3.0), seed=1,
              noise_hu=15.0, **BONE_KW)


def _sphere(n=48, r=16.0):
    g = np.arange(n) - (n - 1) / 2.0
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    return (r - np.sqrt(x**2 + y**2 + z**2)).astype(np.float32)


@pytest.fixture(scope="module")
def coarse_ct():
    """A 3 mm synthetic CT volume of test_ct_path's bone."""
    return jct.synth_ct_volume(**COARSE)


def _weld(tris):
    verts, faces = stl.weld(np.asarray(tris, np.float64))
    _nb, watertight = stl.edge_face_adjacency(faces)
    return verts.shape[0], faces.shape[0], watertight


@pytest.mark.parametrize("case", ["sphere", "coarse_ct", "max_active",
                                  "max_tris"])
def test_marching_tets_matches_jax(case, coarse_ct):
    if case == "coarse_ct":
        vol, origin, spacing = coarse_ct
        args = (vol, 300.0, tuple(map(float, origin)),
                tuple(map(float, spacing)))
        kw = {}
    else:
        args = (_sphere(), 0.0, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
        kw = {"sphere": dict(max_active=300000, max_tris=400000),
              "max_active": dict(max_active=5000, max_tris=400000),
              "max_tris": dict(max_active=300000, max_tris=7000)}[case]
    ref = jmt.marching_tets(*args, **kw)
    got = marching_tets.marching_tets(torch.as_tensor(args[0]), *args[1:],
                                      **kw)
    ref_tris, n = np.asarray(ref.triangles), int(ref.count)
    got_tris = got.triangles.numpy()
    assert got.count.dtype == torch.int32 and int(got.count) == n
    assert got_tris.shape == ref_tris.shape
    assert np.abs(got_tris - ref_tris).max() <= TOL_MM
    assert not got_tris[n:].any() and not ref_tris[n:].any()
    w_ref, w_got = _weld(ref_tris[:n]), _weld(got_tris[:n])
    assert w_got == w_ref
    # the truncated soups lose triangles, so their surfaces are open
    assert w_got[2] == (case in ("sphere", "coarse_ct"))
    if case == "max_tris":
        assert n == 7000


@pytest.mark.parametrize("kw", [
    {},
    COARSE,
    dict(shape=(60, 40, 36), spacing=(5.0, 4.0, 4.0), seed=3,
         side="right", retroversion_deg=30.0, neck_shaft_deg=140.0),
], ids=["default", "coarse", "right"])
def test_synth_ct_volume_bit_equal(kw):
    ref = jct.synth_ct_volume(**kw)
    got = ct.synth_ct_volume(**kw)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and np.array_equal(g, r)


@pytest.fixture(scope="module")
def flax_ct_params():
    return jct_unet.load_params()


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def test_ct_unet_npz_equals_orbax_checkpoint(flax_ct_params):
    with np.load(ct_unet.DEFAULT_NPZ) as z:
        flat = {k: z[k] for k in z.files}
    ref = _flat(flax_ct_params)
    assert len(flat) == len(ref) == 46
    assert flat.keys() == ref.keys()
    for key, arr in ref.items():
        assert np.array_equal(flat[key], arr), key


def test_ct_unet_state_dict_loads_strict():
    with np.load(ct_unet.DEFAULT_NPZ) as z:
        state = convert.ct_unet_state_dict({k: z[k] for k in z.files})
    model = ct_unet.CTUNet()
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
    assert state["down.0.conv0.weight"].shape == (8, 1, 3, 3, 3)
    assert state["up_convs.0.weight"].shape == (16, 32, 2, 2, 2)
    assert state["head.weight"].shape == (1, 8, 1, 1, 1)


@pytest.mark.parametrize("weights", ["shipped", "random"])
def test_ct_unet_matches_flax(weights, flax_ct_params, coarse_ct):
    """Sides 42 x 30 x 27, none a multiple of 4, so pad and crop run."""
    vol = coarse_ct[0][20:62, 9:39, 10:37]
    if weights == "shipped":
        params = flax_ct_params
        model = ct_unet.load_model("cpu")
    else:
        params = jax.jit(jct_unet.CTUNet().init)(
            jax.random.PRNGKey(7), jnp.zeros((1, 16, 16, 16, 1)))
        model = ct_unet.model_from_flat(_flat(params))
    ref = np.asarray(jct_unet.apply_volume(params, vol))
    got = ct_unet.apply_volume(model, torch.as_tensor(vol)).numpy()
    assert got.shape == ref.shape == vol.shape and got.dtype == np.float32
    span = float(ref.max() - ref.min())
    assert span > 0
    assert np.abs(got - ref).max() <= 0.02 * span
    assert ((got > 0) == (ref > 0)).mean() >= 0.995


def _ct_configs():
    """tiny_config with bands and slots for a ~28k-face CT mesh."""
    sizes = dict(
        full=(64, 64), proximal=(96, 128), distal=(48, 96))
    out = []
    for tiny, slice_cfg in ((jtiny_config, JSliceSetConfig),
                            (tiny_config, SliceSetConfig)):
        cfg = tiny(max_faces=32768, max_verts=16384)
        out.append(dataclasses.replace(
            cfg, max_chain=1024, slice_compact_k=1024,
            **{name: slice_cfg(zslice_num=s, interp_num=n, band=4096)
               for name, (s, n) in sizes.items()}))
    return out


def test_volume_to_landmarks_matches_jax(coarse_ct):
    vol, origin, spacing = coarse_ct
    jcfg, cfg = _ct_configs()
    spec_j = jct.volume_to_spec(vol, origin, spacing, 300.0, config=jcfg)
    spec_t = ct.volume_to_spec(vol, origin, spacing, 300.0, config=cfg,
                               device="cpu")
    assert spec_t.watertight and spec_j.watertight
    assert (spec_t.n_faces, spec_t.n_verts) == (spec_j.n_faces,
                                                spec_j.n_verts)
    assert np.array_equal(spec_t.faces, spec_j.faces)
    assert np.abs(spec_t.vertices - spec_j.vertices).max() <= TOL_MM

    ref = JB.landmarks_to_numpy(
        JB.compute_landmarks_batch(JB.stack_bones([spec_j]), cfg=jcfg))
    got = TB.landmarks_to_numpy(
        TB.compute_landmarks_batch(TB.stack_bones([spec_t], "cpu"), cfg=cfg))
    assert got.side_is_left[0] == ref.side_is_left[0]
    assert got.qc_slice_overflow[0] == ref.qc_slice_overflow[0]
    for name in ("neckshaft", "retroversion", "radius_curvature", "neck_z"):
        assert abs(float(getattr(got, name)[0])
                   - float(getattr(ref, name)[0])) < 0.75, name


def test_landmarks_from_volume_needs_a_card(monkeypatch, coarse_ct):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct.landmarks_from_volume(*coarse_ct)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct.segment_volume(coarse_ct[0], "unet")


def test_segment_volume_without_weights_raises(monkeypatch, coarse_ct,
                                               tmp_path):
    monkeypatch.setattr(ct_unet, "DEFAULT_NPZ", tmp_path / "absent.npz")
    with pytest.raises(RuntimeError, match="no trained ct_unet"):
        ct.segment_volume(coarse_ct[0], "unet", device="cpu")
    seg, iso = ct.segment_volume(coarse_ct[0], device="cpu")
    assert iso == 300.0 and torch.equal(seg, torch.as_tensor(coarse_ct[0]))


@pytest.mark.cuda
def test_ct_path_card_matches_cpu(coarse_ct):
    """The card's marching tets and UNet against the port's CPU ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's half of the comparison")
    vol, origin, spacing = coarse_ct
    args = (300.0, tuple(map(float, origin)), tuple(map(float, spacing)))
    want = marching_tets.marching_tets(torch.as_tensor(vol), *args)
    got = marching_tets.marching_tets(torch.as_tensor(vol, device="cuda"),
                                      *args)
    n = int(want.count)
    assert int(got.count) == n
    assert float((got.triangles.cpu() - want.triangles).abs().max()) <= TOL_MM
    assert _weld(got.triangles[:n].cpu().numpy()) == _weld(
        want.triangles[:n].numpy())
    seg_cpu, _ = ct.segment_volume(vol, "unet", device="cpu")
    seg_card, _ = ct.segment_volume(vol, "unet", device="cuda")
    assert ((seg_card.cpu() > 0) == (seg_cpu > 0)).float().mean() >= 0.999
