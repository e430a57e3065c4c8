"""The port's articular-UNet training path (models/unet_train.py, the
trainable models/unet.py, models/convert.py, tools/make_unet_corpus_torch.py)
against the JAX package's, on the CPU at a small size: features (4, 8),
64 x 64 images, batch 4.

Tolerances, stated once:
* rendered images within 1e-5 of JAX's for the same 13 draws, labels equal
  on all but 0.1 % of pixels (the cap's edge);
* the boundary weight exactly; losses within 1e-3 relative (bf16 forward);
* gradients within 3e-2 relative L2 per parameter in bf16 and within 1e-4
  with both models in float32;
* parameters after each of three AdamW steps within 1e-5 absolute in
  float32, the three losses within 1e-3 relative in bf16;
* corpus images within 1e-3, masks equal on all but 0.5 % of pixels.

Cancelling gradients.  Every conv inside a ConvBlock feeds a GroupNorm
whose groups are single channels at these widths, which removes whatever
the conv's bias adds: that bias has a gradient of exactly zero in exact
arithmetic, and what either framework computes for it is the rounding
residue of a sum that cancels (1e-7 of the largest gradient in float32,
up to 8e-2 of it in bf16).  The upsampling conv's bias nearly cancels in
the same way.  Such parameters (`_cancelling`: float32 reference gradient
below 1e-2 of the largest) are held to the float32 tolerance against that
floor, left out of the bf16 comparison, and left out of the comparison
after AdamW steps, where Adam divides the residue by its own size.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import shoulder_tpu.config as jconfig
from shoulder_tpu.config import SliceSetConfig as JSliceSetConfig
from shoulder_tpu.config import tiny_config as jtiny_config
from shoulder_tpu.models import unet as junet
from shoulder_tpu.models import unet_train as jtrain
from shoulder_tpu_torch.config import SliceSetConfig, tiny_config
from shoulder_tpu_torch.models import convert
from shoulder_tpu_torch.models import unet as tunet
from shoulder_tpu_torch.models import unet_train as ttrain

ROOT = Path(__file__).resolve().parents[1]
FEATURES, SIZE, BATCH = (4, 8), 64, 4
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}
CANCEL = 1e-2


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _tree(flat):
    """The nested Flax tree of a flat one."""
    tree = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_draws(key, batch, size):
    """The 13 draws of shoulder_tpu's synth_polar_batch(key, batch, size),
    made as it makes them, under the port's names."""
    ks = jax.random.split(key, 13)

    def f(k, lo, hi):
        return jax.random.uniform(k, (batch, 1, 1), minval=lo, maxval=hi)

    draws = {
        "head_r": f(ks[0], 18.0, 28.0), "off_x": f(ks[1], -8.0, 8.0),
        "off_y": f(ks[2], 4.0, 14.0), "head_cz": f(ks[3], -10.0, 2.0),
        "shaft_r": f(ks[4], 9.0, 14.0), "flare": f(ks[5], 0.0, 12.0),
        "groove_th": f(ks[6], -jnp.pi, jnp.pi),
        "groove_d": f(ks[7], 0.5, 4.0), "groove_w": f(ks[8], 0.08, 0.3),
        "flatten": f(ks[9], 0.0, 0.35),
        "incl": f(ks[12], jnp.deg2rad(30.0), jnp.deg2rad(62.0)),
        "noise": jax.random.normal(ks[10], (batch, size, size)),
        "shift": jax.random.randint(ks[11], (batch,), 0, size),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.fixture(scope="module")
def batches():
    """Three fixed (images, labels) batches from the JAX generator, as
    numpy (B, H, W, 1)."""
    return [tuple(np.asarray(a) for a in
                  jtrain.synth_polar_batch(jax.random.PRNGKey(10 + i),
                                           BATCH, SIZE))
            for i in range(3)]


def _nchw(a):
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def flax_init():
    """Flax's own initial parameters at FEATURES, flat."""
    params = jax.jit(junet.UNet(features=FEATURES).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 1)))
    return _flat(params)


def _models(flat, mode):
    jdt, tdt = DTYPES[mode]
    return (junet.UNet(features=FEATURES, dtype=jdt),
            tunet.model_from_flat(flat, tdt, serving=False))


# ---------------------------------------------------------------- render
@pytest.mark.parametrize("seed,size", [(3, 64), (4, 96)])
def test_render_matches_jax_for_jax_draws(seed, size):
    key = jax.random.PRNGKey(seed)
    ref_im, ref_lb = (np.asarray(a) for a in
                      jtrain.synth_polar_batch(key, BATCH, size))
    draws = _jax_draws(key, BATCH, size)
    assert len(draws) == 13
    im, lb = ttrain.render_polar_batch(draws, size)
    assert im.shape == lb.shape == (BATCH, 1, size, size)
    assert im.dtype == lb.dtype == torch.float32
    assert np.isfinite(ref_im).all() and torch.isfinite(im).all()
    assert np.abs(im[:, 0].numpy() - ref_im[..., 0]).max() <= 1e-5
    assert (lb[:, 0].numpy() != ref_lb[..., 0]).mean() <= 1e-3
    assert 0.02 < lb.mean() < 0.6


def test_polar_draws_shapes_ranges_and_seed():
    gen = torch.Generator().manual_seed(5)
    draws = ttrain.polar_draws(gen, 64, 32)
    assert len(draws) == 13
    for name, lo, hi in ttrain._UNIFORMS:
        d = draws[name]
        assert d.shape == (64, 1, 1)
        assert lo <= float(d.min()) and float(d.max()) <= hi
        assert float(d.max() - d.min()) > 0.5 * (hi - lo)
    assert draws["noise"].shape == (64, 32, 32)
    assert abs(float(draws["noise"].std()) - 1.0) < 0.05
    shift = draws["shift"]
    assert shift.shape == (64,) and shift.dtype == torch.int64
    assert 0 <= int(shift.min()) and int(shift.max()) < 32
    again = ttrain.polar_draws(torch.Generator().manual_seed(5), 64, 32)
    assert all(torch.equal(draws[k], again[k]) for k in draws)
    im, lb = ttrain.synth_polar_batch(torch.Generator().manual_seed(5), 4, 32)
    assert im.shape == lb.shape == (4, 1, 32, 32)
    assert torch.isfinite(im).all() and im.min() == 0 and im.max() == 1


def test_roll_theta_is_numpy_roll_per_sample():
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    got = ttrain._roll_theta(x, torch.tensor([3, 0]))
    assert np.array_equal(got[0].numpy(), np.roll(x[0].numpy(), 3, axis=-1))
    assert torch.equal(got[1], x[1])


# ---------------------------------------------------------------- losses
def test_boundary_weight_equal(batches):
    for _, labels in batches:
        ref = np.asarray(jtrain._boundary_weight(jnp.asarray(labels)))
        got = ttrain._boundary_weight(_nchw(labels))
        assert got.shape == (BATCH, 1, SIZE, SIZE)
        assert np.array_equal(got[:, 0].numpy(), ref[..., 0])
        assert set(np.unique(ref)) == {1.0, 5.0}


@pytest.mark.parametrize("loss", ["bce_loss", "dice_bce_loss"])
def test_losses_match_jax(loss, flax_init, batches):
    jmodel, tmodel = _models(flax_init, "bf16")
    images, labels = batches[0]
    ref = float(getattr(jtrain, loss)(_tree(flax_init), jmodel,
                                      jnp.asarray(images),
                                      jnp.asarray(labels)))
    with torch.no_grad():
        got = float(getattr(ttrain, loss)(tmodel, _nchw(images),
                                          _nchw(labels)))
    assert math.isfinite(ref) and abs(got - ref) <= 1e-3 * abs(ref)


# -------------------------------------------------------------- gradient
def _jax_grads(flat, mode, images, labels):
    jmodel, _ = _models(flat, mode)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, i, l: jtrain.dice_bce_loss(p, jmodel, i, l)))(
            _tree(flat), jnp.asarray(images), jnp.asarray(labels))
    return float(loss), convert.unet_state_dict(_flat(grads))


def _cancelling(ref_f32):
    """Names whose float32 reference gradient is below CANCEL of the
    largest (see the module docstring), and that largest norm."""
    top = max(float(g.norm()) for g in ref_f32.values())
    return {n for n, g in ref_f32.items()
            if float(g.norm()) < CANCEL * top}, top


@pytest.fixture(scope="module")
def grads_f32(flax_init, batches):
    return _jax_grads(flax_init, "f32", *batches[0])


@pytest.mark.parametrize("mode,tol", [("bf16", 3e-2), ("f32", 1e-4)])
def test_gradients_match_jax(mode, tol, flax_init, batches, grads_f32):
    images, labels = batches[0]
    ref_loss, ref = (grads_f32 if mode == "f32"
                     else _jax_grads(flax_init, mode, images, labels))
    cancelling, top = _cancelling(grads_f32[1])
    # the conv biases inside the blocks, and the upsampling conv's
    assert {n for n in ref if ".conv" in n and n.endswith(".bias")} \
        <= cancelling
    assert len(cancelling) <= 7 and len(ref) == 28

    _, tmodel = _models(flax_init, mode)
    loss = ttrain.dice_bce_loss(tmodel, _nchw(images), _nchw(labels))
    loss.backward()
    assert abs(loss.item() - ref_loss) <= 1e-3 * abs(ref_loss)
    for name, p in tmodel.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        err = float((p.grad - ref[name]).norm())
        if name in cancelling:
            if mode == "f32":
                assert err <= tol * CANCEL * top, name
            continue
        assert err <= tol * float(ref[name].norm()), (name, err)


# ----------------------------------------------------------------- steps
def _jax_steps(flat, mode, batches, lr, opt_state=None):
    """Three optax.adamw steps on the fixed batches; the parameters
    (as a port state_dict) and the loss after each, and the optimiser
    state the steps started from."""
    jmodel, _ = _models(flat, mode)
    tx = optax.adamw(lr)
    params = _tree(flat)
    if opt_state is None:
        opt_state = tx.init(params)
    start = opt_state

    @jax.jit
    def step(params, opt_state, images, labels):
        loss, grads = jax.value_and_grad(jtrain.dice_bce_loss)(
            params, jmodel, images, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    out = []
    for images, labels in batches:
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(images),
                                       jnp.asarray(labels))
        out.append((convert.unet_state_dict(_flat(params)), float(loss)))
    return out, start, (params, opt_state)


def _torch_steps(flat, mode, batches, lr, start):
    _, tmodel = _models(flat, mode)
    opt = ttrain.adamw(tmodel, lr)
    adam = start[0]
    convert.adamw_state(tmodel, opt, int(adam.count), _flat(adam.mu),
                        _flat(adam.nu))
    out = []
    for images, labels in batches:
        loss = ttrain.train_step(tmodel, opt, ttrain.dice_bce_loss,
                                 _nchw(images), _nchw(labels))
        out.append(({k: v.clone() for k, v in tmodel.state_dict().items()},
                    float(loss)))
    return out


@pytest.mark.parametrize("carried", [False, True],
                         ids=["fresh_state", "carried_state"])
def test_three_adamw_steps_match_optax(carried, flax_init, batches,
                                       grads_f32):
    lr = 3e-4
    cancelling, _ = _cancelling(grads_f32[1])
    flat, opt_state = flax_init, None
    if carried:
        # two JAX steps first: non-zero count, mu and nu to carry across
        _, _, (params, opt_state) = _jax_steps(flax_init, "f32",
                                               batches[1:], lr)
        flat = _flat(params)
        assert int(opt_state[0].count) == 2
        assert max(float(np.abs(m).max())
                   for m in _flat(opt_state[0].nu).values()) > 0
    ref, start, _ = _jax_steps(flat, "f32", batches, lr, opt_state)
    got = _torch_steps(flat, "f32", batches, lr, start)
    first = convert.unet_state_dict(flat)
    moved = 0.0
    for (ref_p, ref_loss), (got_p, got_loss) in zip(ref, got):
        assert abs(got_loss - ref_loss) <= 1e-5 * abs(ref_loss)
        for name in ref_p:
            if name in cancelling:
                continue
            assert float((got_p[name] - ref_p[name]).abs().max()) <= 1e-5, name
        moved = max(moved, max(float((ref_p[n] - first[n]).abs().max())
                               for n in ref_p))
    assert moved > 10 * 1e-5      # the steps moved what the tolerance holds

    ref16, start16, _ = _jax_steps(flat, "bf16", batches, lr, opt_state)
    got16 = _torch_steps(flat, "bf16", batches, lr, start16)
    for (_, ref_loss), (_, got_loss) in zip(ref16, got16):
        assert abs(got_loss - ref_loss) <= 1e-3 * abs(ref_loss)


@pytest.mark.parametrize("grads", ["zero", "random"])
def test_adamw_is_optax_adamw(grads, flax_init):
    """The optimiser alone, on gradients handed to both: optax.adamw's
    decay is 1e-4 on every parameter, biases and GroupNorm scales too.
    With zero gradients only the decay acts, so torch's default 1e-2, or
    a decay that skipped the biases, shows at once.  With random
    gradients the two agree to 1e-4 of a step, not to rounding: optax
    takes the bias correction 1 - 0.999^t in float32, torch in double."""
    lr = 0.1
    rng = np.random.default_rng(0)
    flat = {k: (v + 1.0).astype(np.float32) for k, v in flax_init.items()}
    g_flat = {k: (np.zeros_like(v) if grads == "zero"
                  else rng.standard_normal(v.shape).astype(np.float32))
              for k, v in flat.items()}
    tx = optax.adamw(lr)
    params = _tree(flat)
    opt_state = tx.init(params)
    _, tmodel = _models(flat, "f32")
    opt = ttrain.adamw(tmodel, lr)
    g_state = convert.unet_state_dict(g_flat)
    for _ in range(3):
        updates, opt_state = tx.update(_tree(g_flat), opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, p in tmodel.named_parameters():
            p.grad = g_state[name].clone()
        opt.step()
    ref = convert.unet_state_dict(_flat(params))
    for name, p in tmodel.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) <= 1e-4 * lr, name
    if grads == "zero":
        want = (1.0 - lr * 1e-4) ** 3
        bias = tmodel.down[0].conv0.bias.detach()
        assert torch.allclose(bias, torch.full_like(bias, want), atol=2e-7)
        # 1e-2 would give 0.997, no decay on biases 1.0
        assert abs(want - (1.0 - lr * 1e-2) ** 3) > 1e-3
        assert abs(want - 1.0) > 2e-5


# ------------------------------------------------------------------ init
def test_init_flax_like_distribution():
    model = tunet.UNet(features=(32, 64))
    for p in model.parameters():                  # whatever torch drew
        torch.nn.init.constant_(p, 7.0)
    tunet.init_flax_like(model, torch.Generator().manual_seed(0))
    ref = _flat(jax.jit(junet.UNet(features=(32, 64)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1))))
    ref = convert.unet_state_dict(ref)
    wide = 0
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            w = mod.weight.detach()
            fan_in = w[0].numel()
            assert torch.count_nonzero(mod.bias) == 0
            # no value beyond two standard deviations of the untruncated
            # normal, whose sigma is sqrt(1 / fan_in) / 0.8796
            bound = 2.0 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(w.abs().max()) <= bound * (1 + 1e-6)
            assert float(ref[name + ".weight"].abs().max()) <= bound * (1 + 1e-6)
            if w.numel() >= 8192:
                wide += 1
                target = math.sqrt(1.0 / fan_in)
                assert abs(float(w.std()) - target) <= 0.05 * target
                assert abs(float(w.mean())) <= 0.05 * target
                assert abs(float(ref[name + ".weight"].std()) - target) \
                    <= 0.05 * target
                # truncation shows: the tails reach beyond 1.9 sigma
                assert float(w.abs().max()) >= 0.95 * bound
        elif isinstance(mod, torch.nn.GroupNorm):
            assert (mod.weight == 1).all() and (mod.bias == 0).all()
    assert wide >= 4
    again = tunet.UNet(features=(32, 64))
    tunet.init_flax_like(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


# ------------------------------------------------------------ checkpoint
@pytest.mark.parametrize("features", [(4, 8), (16, 32, 64, 128)])
def test_state_dict_flat_round_trip(features):
    model = tunet.UNet(features)
    tunet.init_flax_like(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in model.parameters():     # biases and scales off 0 / 1 too
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.1)
    state = model.state_dict()
    flat = convert.unet_flat_params(state)
    shapes = jax.eval_shape(
        junet.UNet(features=features).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 1)))
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
           for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    assert {k: v.shape for k, v in flat.items()} == ref
    assert all(v.dtype == np.float32 for v in flat.values())
    back = convert.unet_state_dict(flat)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    assert tunet.features_of(flat) == tuple(features)
    # HWIO: a kernel entry lands where Flax reads it
    w = state["down.0.conv1.weight"]
    assert flat["params/ConvBlock_0/Conv_1/kernel"][2, 0, 1, 3] == w[3, 1, 2, 0]


def test_shipped_npz_round_trips_through_state_dict():
    flat = ttrain.load_params()
    model = tunet.model_from_flat(flat, serving=False)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    back = convert.unet_flat_params(model.state_dict())
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_saved_checkpoint_feeds_flax_and_is_served(tmp_path):
    """A zero-step save of the shipped weights: the npz read back into the
    Flax model gives the port's mask within tests/test_torch_unet.py's
    tolerance (pixel agreement >= 99.5 %), and `load_model` serves the
    file with the logits of the in-memory model, bit for bit."""
    model = tunet.model_from_flat(ttrain.load_params(), serving=False)
    path = tmp_path / "trained.npz"
    ttrain.save_params(model, path)
    assert ttrain.load_params(tmp_path / "absent.npz") is None

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:512, 0:512] / 512.0
    img = 0.6 * (1 - yy) ** 1.5 + 0.1 * np.sin(
        2 * np.pi * (xx + rng.random())) * (1 - yy)
    img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
    ref = np.asarray(junet.segment_image(_tree(ttrain.load_params(path)),
                                         jnp.asarray(img)))
    served = tunet.load_model("cpu", path)
    got = tunet.segment_image(served, torch.as_tensor(img)).numpy()
    assert 0.005 < ref.mean() < 0.5
    assert (got == ref).mean() >= 0.995
    shipped = tunet.load_model("cpu")
    x = torch.as_tensor(img)[None, None]
    with torch.no_grad():
        assert torch.equal(served(x), shipped(x))


def test_load_model_serves_a_rewritten_file(tmp_path):
    path = tmp_path / "unet.npz"
    x = torch.rand((1, 1, 32, 32), generator=torch.Generator().manual_seed(2))
    logits = []
    for seed in (0, 1):
        model = ttrain.new_model(torch.Generator().manual_seed(seed),
                                 features=FEATURES)
        ttrain.save_params(model, path)          # the same path both times
        served = tunet.load_model("cpu", path)
        assert served.features == FEATURES and not served.training
        assert served.down[0].conv0.weight.dtype == torch.bfloat16
        assert served.head.weight.dtype == torch.float32
        with torch.no_grad():
            logits.append(served(x))
            assert torch.equal(logits[-1], tunet.serving_(model)(x))
        assert tunet.load_model("cpu", path) is served
    assert not torch.equal(logits[0], logits[1])


def test_serving_form_equals_per_call_cast():
    """Rounding the conv weights once (serving) and casting them in every
    call (training) give the same logits bit for bit."""
    flat = ttrain.load_params()
    x = torch.rand((2, 1, 64, 64), generator=torch.Generator().manual_seed(3))
    train_form = tunet.model_from_flat(flat, serving=False).eval()
    with torch.no_grad():
        assert torch.equal(train_form(x), tunet.load_model("cpu")(x))


# --------------------------------------------------------------- trainer
@pytest.mark.parametrize("batch,frac", [(16, 0.25), (8, 0.25), (4, 0.0),
                                        (4, 1.0), (6, 0.4), (2, 0.25)])
def test_mixture_counts(batch, frac):
    n_proc = max(1, int(round(batch * frac)))
    assert ttrain.mixture_counts(batch, frac) == (n_proc, batch - n_proc)


def _corpus(n=8):
    rng = np.random.default_rng(4)
    images = rng.random((n, SIZE, SIZE)).astype(np.float16)
    masks = np.zeros((n, SIZE, SIZE), np.uint8)
    masks[:, 8:30, 10:40] = 1
    return images, masks


def test_train_mixture_runs_and_is_reproducible():
    images, masks = _corpus()
    runs = []
    for _ in range(2):
        model, losses = ttrain.train_mixture(
            images, masks, steps=5, batch=BATCH, size=SIZE, log_every=1,
            features=FEATURES, device="cpu",
            generator=torch.Generator().manual_seed(11))
        runs.append((model.state_dict(), losses))
    (state_a, losses_a), (state_b, losses_b) = runs
    assert len(losses_a) == 5 and np.isfinite(losses_a).all()
    assert losses_a == losses_b
    assert all(torch.equal(state_a[k], state_b[k]) for k in state_a)
    _, other = ttrain.train_mixture(
        images, masks, steps=2, batch=BATCH, size=SIZE, log_every=1,
        features=FEATURES, device="cpu", seed=12)
    assert other[0] != losses_a[0]


def test_mixture_batch_layout():
    images, masks = (torch.as_tensor(a).to(torch.float16) for a in _corpus())
    gen = torch.Generator().manual_seed(0)
    im, lb = ttrain.mixture_batch(gen, images, masks, 3, 1, SIZE)
    assert im.shape == lb.shape == (4, 1, SIZE, SIZE)
    assert im.dtype == lb.dtype == torch.float32
    # corpus labels stay {0, 1} and keep their area under the roll
    assert set(lb[:3].unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(lb[:3].sum(dim=(1, 2, 3)),
                       masks[:3].float().sum(dim=(1, 2)))


def test_train_procedural_and_resume():
    model, losses = ttrain.train(steps=3, batch=BATCH, size=SIZE,
                                 log_every=2, features=FEATURES,
                                 device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    flat = convert.unet_flat_params(model.state_dict())
    resumed, _ = ttrain.train_mixture(
        *_corpus(), steps=1, batch=BATCH, size=SIZE, lr=0.0,
        init_params=flat, device="cpu")
    assert resumed.features == FEATURES
    for k, v in resumed.state_dict().items():   # lr 0: the start, decayed by 0
        assert torch.equal(v, model.state_dict()[k])


def test_training_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(steps=1, batch=1, size=16, features=FEATURES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_mixture(*_corpus(), steps=1, features=FEATURES)


# ---------------------------------------------------------------- corpus
def _corpus_configs():
    """tiny_config's stacks over the corpus bones' 40,960 faces."""
    out = []
    for tiny, sset in ((jtiny_config, JSliceSetConfig),
                       (tiny_config, SliceSetConfig)):
        out.append(dataclasses.replace(
            tiny(max_faces=40960, max_verts=24576),
            full=sset(zslice_num=64, interp_num=64, band=2048),
            proximal=sset(zslice_num=96, interp_num=128, band=1024)))
    return out


def test_build_corpus_matches_jax_tool(monkeypatch):
    """The same two bones through both tools.

    The JAX tool slices without the bone's original face ids, so each of
    its loops starts at its smallest presorted id, where the pipeline
    (and the port's tool) starts it at the smallest original id; the
    resampled contours then differ in phase.  For this comparison the
    port is handed presorted ids too."""
    jtool = _load_tool("make_unet_corpus")
    ttool = _load_tool("make_unet_corpus_torch")
    jcfg, tcfg = _corpus_configs()
    for tool in (jtool, ttool):
        monkeypatch.setattr(tool, "BATCH", 2)
    monkeypatch.setattr(jconfig, "DEFAULT_CONFIG", jcfg)

    bone_tensors = ttool.B.bone_tensors

    def presorted_ids(spec, device):
        bt = bone_tensors(spec, device)
        return bt._replace(face_orig=torch.arange(
            bt.faces.shape[0], dtype=torch.int32, device=bt.faces.device))

    monkeypatch.setattr(ttool.B, "bone_tensors", presorted_ids)
    got_im, got_mk = ttool.build_corpus(2, 5, config=tcfg, device="cpu")
    ref_im, ref_mk = jtool.build_corpus(2, 5)
    assert got_im.shape == ref_im.shape == (2, 82, 128)
    assert got_im.dtype == np.float16 and got_mk.dtype == np.uint8
    assert np.isfinite(got_im).all()
    assert np.abs(got_im.astype(np.float32)
                  - ref_im.astype(np.float32)).max() <= 1e-3
    assert (got_mk != ref_mk).mean() <= 5e-3
    for mk in got_mk:
        assert 0.05 < mk.mean() < 0.95


def test_build_corpus_rejections_and_checkpoint(monkeypatch, tmp_path):
    """A bone whose mask fraction is out of range is dropped and another
    batch is drawn; the corpus so far is saved after every batch."""
    ttool = _load_tool("make_unet_corpus_torch")
    _, tcfg = _corpus_configs()
    monkeypatch.setattr(ttool, "BATCH", 1)
    extract_one, calls = ttool.extract_one, []

    def first_rejected(*args, **kwargs):
        image, mask = extract_one(*args, **kwargs)
        calls.append(1)
        return image, (torch.zeros_like(mask) if len(calls) == 1 else mask)

    monkeypatch.setattr(ttool, "extract_one", first_rejected)
    out = tmp_path / "corpus.npz"
    images, masks = ttool.build_corpus(1, 5, out_path=out, config=tcfg,
                                       device="cpu")
    assert len(calls) == 2 and images.shape == (1, 82, 128)
    with np.load(out) as z:
        assert np.array_equal(z["images"], images)
        assert np.array_equal(z["masks"], masks)
