"""The port's data-parallel UNet training over a bone mesh
(models/unet_train.py: `mesh_step`, `train(mesh=)`, `dryrun`) against its
meshless step and the JAX package's sharded step, on the CPU.

Meshes of CPU devices stand in for cards (`bone_mesh` takes the devices
it is given); the JAX side runs on conftest's virtual CPU devices, its
step under `NamedSharding(mesh, P("dp"))` as `shoulder_tpu.models.
unet_train.train(mesh=)` shards it.  Small size: features (4, 8), 64 x 64
images, batch 4; the port's Flax-like initial parameters and procedural
batch go to both sides (through models/convert.py), so the JAX side
compiles its sharded steps and nothing else.

Tolerances, stated once (tests/test_torch_train.py's): gradients within
3e-2 relative L2 per parameter in bf16 and 1e-4 in float32 (each shard's
bf16 weight gradient is rounded on its own, so a sharded step is close to
the unsharded one, not equal); parameters after one AdamW step within
1e-5 absolute in float32; losses within 1e-3 relative.  The biases whose
float32 gradient cancels to a rounding residue (below 1e-2 of the largest
gradient; see tests/test_torch_train.py) are held to the float32
tolerance against that floor and left out of the bf16 and parameter
comparisons.  A one-device mesh is the meshless step bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shoulder_tpu.models import unet as junet
from shoulder_tpu.models import unet_train as jtrain
from shoulder_tpu_torch.models import convert
from shoulder_tpu_torch.models import unet as tunet
from shoulder_tpu_torch.models import unet_train as ttrain
from shoulder_tpu_torch.parallel import mesh as tmesh

FEATURES, SIZE, BATCH, LR = (4, 8), 64, 4, 3e-4
CPU = torch.device("cpu")
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}
TOL = {"bf16": 3e-2, "f32": 1e-4}
CANCEL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and a worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def flax_init():
    """The port's Flax-like initial parameters as a flat Flax tree."""
    model = ttrain.new_model(torch.Generator().manual_seed(1),
                             features=FEATURES)
    return convert.unet_flat_params(model.state_dict())


@pytest.fixture(scope="module")
def batch():
    """One procedural batch from the port's generator, NCHW numpy."""
    return tuple(a.numpy() for a in ttrain.synth_polar_batch(
        torch.Generator().manual_seed(20), BATCH, SIZE))


def _nchw(a):
    return torch.from_numpy(a.copy())


def _port_step(flat, mode, batch, mesh=None):
    """One port step from `flat`: (loss, gradient, parameters after it)
    of the first device's model; meshless when `mesh` is None."""
    model = tunet.model_from_flat(flat, DTYPES[mode][1], serving=False)
    opt = ttrain.adamw(model, LR)
    images, labels = (_nchw(a) for a in batch)
    if mesh is None:
        loss = ttrain.train_step(model, opt, ttrain.bce_loss, images, labels)
    else:
        loss = ttrain.mesh_step(ttrain.replicas(model, mesh), opt,
                                ttrain.bce_loss, images, labels, mesh)
    return (float(loss), {n: p.grad.clone() for n, p in
                          model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


@functools.cache
def _jax_stepper(mode):
    """JAX's jitted step for `mode`, one per dtype, so each mesh size
    reuses its trace: (parameters after one optax.adamw step, loss,
    gradient)."""
    jmodel = junet.UNet(features=FEATURES, dtype=DTYPES[mode][0])
    tx = optax.adamw(LR)

    @jax.jit
    def step(params, opt_state, images, labels):
        loss, grads = jax.value_and_grad(
            lambda p: jtrain.bce_loss(p, jmodel, images, labels))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, grads

    return tx, step


def _jax_step(flat, mode, batch, n_dev):
    """JAX's step (loss, gradient, parameters after one optax.adamw step)
    with the batch sharded over `n_dev` virtual CPU devices and the
    parameters and optimiser state replicated."""
    tx, step = _jax_stepper(mode)
    params = _tree(flat)
    opt_state = tx.init(params)
    images, labels = (jnp.asarray(a.transpose(0, 2, 3, 1)) for a in batch)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("dp"))
    params, loss, grads = step(jax.device_put(params, repl),
                               jax.device_put(opt_state, repl),
                               jax.device_put(images, data),
                               jax.device_put(labels, data))
    return (float(loss), convert.unet_state_dict(_flat(grads)),
            convert.unet_state_dict(_flat(params)))


@pytest.fixture(scope="module")
def reference_f32(flax_init, batch):
    """The meshless float32 gradient: which biases cancel, and the
    largest gradient norm."""
    grads = _port_step(flax_init, "f32", batch)[1]
    top = max(float(g.norm()) for g in grads.values())
    cancelling = {n for n, g in grads.items()
                  if float(g.norm()) < CANCEL * top}
    assert {n for n in grads if ".conv" in n and n.endswith(".bias")} \
        <= cancelling and len(cancelling) <= 7
    return cancelling, top


def _assert_grads_close(got, want, mode, reference_f32):
    cancelling, top = reference_f32
    tol = TOL[mode]
    for name, g in got.items():
        err = float((g - want[name]).norm())
        if name in cancelling:
            if mode == "f32":
                assert err <= tol * CANCEL * top, name
            continue
        assert err <= tol * float(want[name].norm()), (name, err)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_mesh_step_matches_meshless_and_jax_sharded(
        flax_init, batch, reference_f32, mode, n_dev):
    mesh = tmesh.bone_mesh([CPU] * n_dev)
    loss, grads, params = _port_step(flax_init, mode, batch, mesh)
    for ref_loss, ref_grads, ref_params in (
            _port_step(flax_init, mode, batch),
            _jax_step(flax_init, mode, batch, n_dev)):
        assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss)
        _assert_grads_close(grads, ref_grads, mode, reference_f32)
        if mode == "f32":
            for name, p in params.items():
                if name not in reference_f32[0]:
                    assert float((p - ref_params[name]).abs().max()) <= 1e-5


def test_mesh_step_keeps_replicas_equal(flax_init, batch):
    mesh = tmesh.bone_mesh([CPU] * 4)
    model = tunet.model_from_flat(flax_init, serving=False)
    models = ttrain.replicas(model, mesh)
    assert models[0] is model and len({id(m) for m in models}) == 4
    opt = ttrain.adamw(model, LR)
    images, labels = (_nchw(a) for a in batch)
    for _ in range(2):
        ttrain.mesh_step(models, opt, ttrain.bce_loss, images, labels, mesh)
    for other in models[1:]:
        for p, q in zip(model.parameters(), other.parameters()):
            assert torch.equal(p, q)


def _meshless_train(steps, device):
    """`train`'s loop with the one-device `train_step` in place of
    `mesh_step`: its default seed, learning rate and draws."""
    gen = ttrain.training_generator(None, 0, device)
    model = ttrain.new_model(gen, features=FEATURES)
    opt = ttrain.adamw(model, LR)
    losses = [float(ttrain.train_step(model, opt, ttrain.bce_loss,
                                      *ttrain.synth_polar_batch(gen, BATCH,
                                                                SIZE)))
              for _ in range(steps)]
    return model, losses


def test_one_device_mesh_is_meshless_bit_for_bit():
    model, losses = _meshless_train(3, "cpu")
    kw = dict(steps=3, batch=BATCH, size=SIZE, log_every=1,
              features=FEATURES)
    for trained, trained_losses in (
            ttrain.train(mesh=tmesh.bone_mesh([CPU]), **kw),
            ttrain.train(device="cpu", **kw)):
        assert losses == trained_losses
        for (k, v), w in zip(model.state_dict().items(),
                             trained.state_dict().values()):
            assert torch.equal(v, w), k


def test_sharded_and_meshless_draw_the_same_batches(monkeypatch):
    drawn = {}

    def run(key, **kw):
        draws = drawn.setdefault(key, [])

        def synth(*args, **kwargs):
            out = synth_batch(*args, **kwargs)
            draws.append(out)
            return out

        monkeypatch.setattr(ttrain, "synth_polar_batch", synth)
        ttrain.train(steps=2, batch=BATCH, size=SIZE, features=FEATURES,
                     **kw)

    synth_batch = ttrain.synth_polar_batch
    run("meshless", device="cpu")
    run("sharded", mesh=tmesh.bone_mesh([CPU] * 2))
    assert len(drawn["meshless"]) == len(drawn["sharded"]) == 2
    for a, b in zip(drawn["meshless"], drawn["sharded"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_uneven_split_and_wrong_device_raise_and_dryrun_runs():
    mesh = tmesh.bone_mesh([CPU] * 2)
    with pytest.raises(ValueError, match="do not split"):
        ttrain.train(steps=1, batch=3, size=SIZE, features=FEATURES,
                     mesh=mesh)
    with pytest.raises(ValueError, match="first device"):
        ttrain.train(steps=1, batch=4, size=SIZE, features=FEATURES,
                     mesh=mesh, device="cuda")
    for n_dev in (1, 2, 4):
        loss = ttrain.dryrun(tmesh.bone_mesh([CPU] * n_dev))
        assert np.isfinite(loss) and 0.0 < loss < 5.0
    # the dryrun's step is the same whatever the mesh, within bf16
    assert ttrain.dryrun(tmesh.bone_mesh([CPU] * 4)) == pytest.approx(
        ttrain.dryrun(tmesh.bone_mesh([CPU])), rel=1e-3)
