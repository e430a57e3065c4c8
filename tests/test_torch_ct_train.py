"""The port's CT-UNet training path (models/ct_unet.py: `train`,
`save_params`, `load_params`, the trainable CTUNet) against the JAX
package's, on the CPU at the shipped widths (8, 16, 32) on 16 x 16 x 16
volumes.

Tolerances: with one seed both `train`s see bit-equal volumes; one step
from the same weights gives the loss within 1e-3 relative and every
parameter's gradient within 1e-4 relative L2 with both models in float32
(measured: 1.3e-5 at most), which is what shows the backward is right.
In bf16 every parameter but the conv biases is within 3e-2.  A conv bias
feeds a GroupNorm over groups of two to eight channels, which removes
the group's mean: its gradient is a sum over all voxels that cancels
within each group, so bf16 rounding moves it by 2-43 % in the JAX
package itself (its bf16 gradient against its float32 one).  A conv bias
is therefore held in bf16 to three times JAX's own bf16-to-float32
distance for that parameter, or 3e-2, whichever is larger (measured:
0.9-1.4 times).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import shoulder_tpu.pipeline.ct as jct
from shoulder_tpu.models import ct_unet as jct_unet
from shoulder_tpu_torch.models import convert
from shoulder_tpu_torch.models import ct_unet
from shoulder_tpu_torch.models import unet as tunet
from shoulder_tpu_torch.models import unet_train as ttrain
from shoulder_tpu_torch.pipeline import ct

SIZE = (16, 16, 16)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _tree(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _recording(fn, sink):
    def wrapped(**kwargs):
        out = fn(**kwargs)
        sink.append((kwargs, out[0].copy()))
        return out
    return wrapped


def test_both_trains_see_equal_volumes(monkeypatch):
    """Seed 3, two steps: the volumes and the bone parameters handed to
    synth_ct_volume, recorded on both sides, are equal exactly."""
    seen_j, seen_t = [], []
    monkeypatch.setattr(jct, "synth_ct_volume",
                        _recording(jct.synth_ct_volume, seen_j))
    monkeypatch.setattr(ct, "synth_ct_volume",
                        _recording(ct.synth_ct_volume, seen_t))
    _, losses_j = jct_unet.train(steps=2, size=SIZE, seed=3, log_every=1)
    model, losses_t = ct_unet.train(steps=2, size=SIZE, seed=3, log_every=1,
                                    device="cpu")
    assert len(seen_j) == len(seen_t) == 2
    for (kw_j, vol_j), (kw_t, vol_t) in zip(seen_j, seen_t):
        assert kw_j == kw_t and kw_t["shape"] == SIZE
        assert vol_t.dtype == np.float32 and np.array_equal(vol_j, vol_t)
    assert not np.array_equal(seen_t[0][1], seen_t[1][1])
    assert len(losses_t) == len(losses_j) == 2
    assert np.isfinite(losses_t).all() and np.isfinite(losses_j).all()
    assert isinstance(model, ct_unet.CTUNet) and model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.fixture(scope="module")
def flax_init():
    params = jax.jit(jct_unet.CTUNet().init)(
        jax.random.PRNGKey(7), jnp.zeros((1, *SIZE, 1)))
    return _flat(params)


@pytest.fixture(scope="module")
def volume():
    vol, _, _ = ct.synth_ct_volume(shape=SIZE, spacing=(300.0 / 16, 1.8, 1.8),
                                   seed=2)
    return vol / np.float32(ct_unet.HU_SCALE), (vol > 350.0).astype(np.float32)


def _jax_grads(flat, dtype, v, label):
    model = jct_unet.CTUNet(dtype=dtype)

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(v)[None, ..., None])
        return jnp.mean(optax.sigmoid_binary_cross_entropy(
            logits, jnp.asarray(label)[None, ..., None]))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(_tree(flat))
    return float(loss), convert.ct_unet_state_dict(_flat(grads))


@pytest.mark.parametrize("mode,tol", [("bf16", 3e-2), ("f32", 1e-4)])
def test_one_step_loss_and_gradients_match_jax(mode, tol, flax_init, volume):
    v, label = volume
    assert 0.02 < label.mean() < 0.9
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[mode]
    _, ref32 = _jax_grads(flax_init, jnp.float32, v, label)
    ref_loss, ref = _jax_grads(flax_init, jdt, v, label)

    model = ct_unet.model_from_flat(flax_init, tdt, serving=False)
    loss = ttrain.bce_loss(model, torch.as_tensor(v)[None, None],
                           torch.as_tensor(label)[None, None])
    loss.backward()
    assert abs(loss.item() - ref_loss) <= 1e-3 * abs(ref_loss)
    biases = 0
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32
        err = float((p.grad - ref[name]).norm())
        allowed = tol * float(ref[name].norm())
        if mode == "bf16" and "conv" in name and name.endswith(".bias"):
            biases += 1
            allowed = max(allowed,
                          3.0 * float((ref[name] - ref32[name]).norm()))
        assert err <= allowed, (name, err, allowed)
    assert biases == (12 if mode == "bf16" else 0)


def test_ct_state_dict_flat_round_trip(flax_init):
    model = ct_unet.CTUNet()
    tunet.init_flax_like(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1)
    state = model.state_dict()
    flat = convert.ct_unet_flat_params(state)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in flax_init.items()}
    back = convert.ct_unet_state_dict(flat)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    # DHWIO: a kernel entry lands where Flax reads it
    w = state["down.0.conv1.weight"]
    assert flat["params/ConvBlock3D_0/Conv_1/kernel"][2, 0, 1, 3, 5] \
        == w[5, 3, 2, 0, 1]
    shipped = ct_unet.load_params()
    again = convert.ct_unet_flat_params(
        ct_unet.model_from_flat(shipped, serving=False).state_dict())
    assert all(np.array_equal(again[k], shipped[k]) for k in shipped)


def test_ct_checkpoint_is_served_also_after_a_rewrite(tmp_path, volume):
    path = tmp_path / "ct_unet.npz"
    assert ct_unet.load_params(path) is None
    vol = torch.as_tensor(volume[0] * ct_unet.HU_SCALE)
    logits = []
    for seed in (0, 1):
        model = ct_unet.CTUNet()
        tunet.init_flax_like(model, torch.Generator().manual_seed(seed))
        ct_unet.save_params(model, path)
        served = ct_unet.load_model("cpu", path)
        assert served.down[0].conv0.weight.dtype == torch.bfloat16
        assert not served.training
        logits.append(ct_unet.apply_volume(served, vol))
        assert torch.equal(logits[-1],
                           ct_unet.apply_volume(tunet.serving_(model), vol))
    assert not torch.equal(logits[0], logits[1])
    # a zero-step save of the shipped weights serves the shipped logits
    ct_unet.save_params(
        ct_unet.model_from_flat(ct_unet.load_params(), serving=False), path)
    assert torch.equal(
        ct_unet.apply_volume(ct_unet.load_model("cpu", path), vol),
        ct_unet.apply_volume(ct_unet.load_model("cpu"), vol))


def test_ct_train_resumes_and_is_reproducible():
    runs = [ct_unet.train(steps=3, size=SIZE, seed=5, log_every=1,
                          device="cpu") for _ in range(2)]
    (model_a, losses_a), (model_b, losses_b) = runs
    assert losses_a == losses_b and len(losses_a) == 3
    assert all(torch.equal(a, b) for a, b in
               zip(model_a.parameters(), model_b.parameters()))
    resumed, losses = ct_unet.train(
        steps=1, size=SIZE, seed=5, log_every=1, lr=0.0, device="cpu",
        init_params=convert.ct_unet_flat_params(model_a.state_dict()))
    assert np.isfinite(losses).all()
    assert all(torch.equal(a, b) for a, b in
               zip(model_a.parameters(), resumed.parameters()))


def test_ct_train_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ct_unet.train(steps=1, size=SIZE)
