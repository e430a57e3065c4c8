"""Trainer of the articular UNet (PyTorch).

Port of shoulder_tpu/models/unet_train.py.  The segmenter is trained on a
procedural generative model of the polar-radius image the pipeline
builds (anatomic-neck stage): a spherical humeral head offset from the
canal axis, a metaphysis and shaft, a bicipital-groove notch, arthritic
flattening and measurement noise, all synthesized in (z, theta) polar
space on the device; `train_mixture` mixes that stream with
pipeline-extracted corpus pairs (tools/make_unet_corpus_torch.py).

Label = the pixel lies on the articular cap of the head sphere.

Where this differs from the JAX module:
* images and labels are (B, 1, H, W), not (B, H, W, 1);
* random numbers come from an explicit `torch.Generator`, not from
  `jax.random`: `polar_draws` makes the generator's 13 draws,
  `render_polar_batch` is everything after them and is deterministic, so
  a test can feed it JAX's own draws;
* checkpoints are an npz in the flat Flax layout (models/convert.py),
  which `unet.load_model` serves from;
* data parallelism over a `parallel.mesh.BoneMesh` (`train(mesh=)`,
  `dryrun`) takes no collectives library: one process drives every
  replica, and the gradients meet on the mesh's first device by explicit
  copies (`mesh_step`).
"""

from __future__ import annotations

import math
import copy
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from shoulder_tpu_torch.models import convert
from shoulder_tpu_torch.models import unet as unet_mod
from shoulder_tpu_torch.models.unet import UNet
from shoulder_tpu_torch.parallel import mesh as pmesh
from shoulder_tpu_torch.utils import geometry as geom

# optax.adamw's defaults (optax 0.2.6): the decay covers every
# parameter, biases and GroupNorm scales too
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)

# the ranges of the procedural generator's per-sample uniforms, in the
# order the JAX module draws them
_UNIFORMS = (
    ("head_r", 18.0, 28.0),
    ("off_x", -8.0, 8.0),
    ("off_y", 4.0, 14.0),          # posterior-ish offset
    ("head_cz", -10.0, 2.0),       # head center below the image top
    ("shaft_r", 9.0, 14.0),
    ("flare", 0.0, 12.0),          # metaphyseal flare amplitude
    ("groove_th", -math.pi, math.pi),
    ("groove_d", 0.5, 4.0),
    ("groove_w", 0.08, 0.3),
    ("flatten", 0.0, 0.35),        # arthritic flattening factor
    ("incl", math.radians(30.0), math.radians(62.0)),
)


def training_generator(generator, seed: int, device) -> torch.Generator:
    """The generator a trainer draws from, on `device` (which raises
    without a card when it names one): the caller's, or a new one seeded
    with `seed`."""
    from shoulder_tpu_torch.bone import _device

    dev = _device(device)
    if generator is None:
        return torch.Generator(device=dev).manual_seed(seed)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"training on {dev}")
    return generator


# ------------------------------------------------------------ data model
def polar_draws(generator: torch.Generator, batch: int, size: int = 512,
                device=None) -> dict:
    """The 13 random draws of one procedural batch, on `device` (the
    generator's by default): eleven uniforms of shape (B, 1, 1) (the ten
    shape parameters and the neck-plane inclination `incl`), the
    (B, size, size) unit normal `noise`, and the integer theta roll
    `shift` of shape (B,) in [0, size)."""
    dev = generator.device if device is None else torch.device(device)
    kw = dict(generator=generator, device=dev)
    draws = {name: lo + (hi - lo) * torch.rand((batch, 1, 1), **kw)
             for name, lo, hi in _UNIFORMS}
    draws["noise"] = torch.randn((batch, size, size), **kw)
    draws["shift"] = torch.randint(0, size, (batch,), **kw)
    return draws


def _roll_theta(x, shift):
    """Each sample of x (B, ..., W) rolled by its own shift along the
    last axis (numpy's roll: out[j] = in[(j - shift) % W])."""
    w = x.shape[-1]
    idx = (torch.arange(w, device=x.device)[None, :] - shift[:, None]) % w
    idx = idx.reshape(x.shape[0], *([1] * (x.dim() - 2)), w)
    return x.gather(-1, idx.expand_as(x))


def render_polar_batch(draws: dict, size: int = 512):
    """(image, label), each (B, 1, size, size) float32, from the draws of
    `polar_draws`.

    Geometry: rays from the canal axis at height z hit either the head
    sphere (radius R, center offset c) or the shaft/metaphysis surface;
    the observed radius is the max of the two, the label is whether the
    head hit wins on the articular cap.
    """
    d = draws
    head_r, off_x, off_y = d["head_r"], d["off_x"], d["off_y"]
    dev = head_r.device
    inf = torch.tensor(float("inf"), device=dev)

    # image rows: z from head top (row 0) downward ~55 mm
    z = geom.linspace(0.0, -55.0, size, device=dev)[None, :, None]
    th = geom.linspace(-math.pi, math.pi, size, endpoint=False,
                       device=dev)[None, None, :]

    # ray from axis at height z, direction theta; head sphere hit radius
    dz = z - d["head_cz"]
    ux, uy = torch.cos(th), torch.sin(th)
    b = ux * off_x + uy * off_y
    c = off_x**2 + off_y**2 - (head_r**2 - dz**2)
    disc = b**2 - c
    hit = disc > 0
    # off the sphere r_head is -inf, and -inf * 0 below is NaN: only the
    # where(hit, ...) of image_r keeps it out of the image
    r_head = torch.where(hit, b + torch.sqrt(torch.clamp(disc, min=0.0)),
                         -inf)

    # articular cap: the sphere cut by the anatomic-neck plane, the
    # off-cap surface dropping into the neck recess crease
    incl = d["incl"]
    az = torch.atan2(off_y, off_x)
    n_x = torch.sin(incl) * torch.cos(az)
    n_y = torch.sin(incl) * torch.sin(az)
    n_z = torch.cos(incl)
    g = (
        (r_head * ux - off_x) * n_x
        + (r_head * uy - off_y) * n_y
        + dz * n_z
        - 0.10 * head_r
    )
    on_cap = hit & (g >= 0.0)
    r_art = torch.where(
        on_cap, r_head, r_head - torch.clamp(1.1 * (-g), 0.0, 6.0))
    # arthritic flattening of one flank of the cap
    dome = torch.clamp(g / (0.45 * head_r), 0.0, 1.0)
    r_art = r_art * (
        1.0 - d["flatten"] * dome
        * torch.clamp(torch.cos(th - az - 0.7), 0, 1) ** 2
    )

    # shaft + flare grows toward the bottom of the window
    depth = torch.clamp((-z - 25.0) / 30.0, 0.0, 1.0)
    r_shaft = d["shaft_r"] + d["flare"] * depth**2

    image_r = torch.maximum(torch.where(hit, r_art, -inf), r_shaft)
    label = (on_cap & (r_art > r_shaft)).to(torch.float32)

    # bicipital groove notch (cut into whichever surface is outermost)
    dth = torch.atan2(torch.sin(th - d["groove_th"]),
                      torch.cos(th - d["groove_th"]))
    notch = d["groove_d"] * torch.exp(-0.5 * (dth / d["groove_w"]) ** 2)
    image_r = image_r - notch

    # noise + per-image min-max normalization (the pipeline's input)
    image_r = image_r + 0.15 * d["noise"]
    lo = torch.amin(image_r, dim=(1, 2), keepdim=True)
    hi = torch.amax(image_r, dim=(1, 2), keepdim=True)
    image = (image_r - lo) / (hi - lo)

    # random roll in theta (the pipeline anchors at the groove; train for
    # robustness to anchor error)
    image = _roll_theta(image, d["shift"])
    label = _roll_theta(label, d["shift"])
    return image[:, None], label[:, None]


def synth_polar_batch(generator: torch.Generator, batch: int,
                      size: int = 512, device=None):
    """Random (image, label) pairs in polar space, (B, 1, size, size)."""
    return render_polar_batch(polar_draws(generator, batch, size, device),
                              size)


# ---------------------------------------------------------------- losses
def bce_loss(model, images, labels):
    return F.binary_cross_entropy_with_logits(model(images), labels)


def _boundary_weight(labels, amp: float = 4.0, halo: int = 5):
    """Per-pixel weight emphasising a halo around the mask boundary.

    The metrics downstream (neck-shaft, retroversion) are driven by where
    the mask edge lands (the plane is fit to edge pixels,
    landmarks._anp_from_mask), so boundary pixels carry most of the loss.
    """
    y = labels[:, 0]
    ez = torch.abs(torch.diff(y, dim=1, prepend=y[:, :1]))
    et = torch.abs(torch.diff(y, dim=2, prepend=y[:, :, :1]))
    e = torch.maximum(ez, et)[:, None]
    e = F.max_pool2d(e, kernel_size=halo, stride=1, padding=halo // 2)
    return 1.0 + amp * e


def dice_bce_loss(model, images, labels, boundary_amp: float = 4.0):
    """Boundary-weighted BCE + soft dice (region-overlap) loss."""
    logits = model(images)
    w = _boundary_weight(labels, boundary_amp)
    bce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    bce = torch.sum(w * bce) / torch.sum(w)
    p = torch.sigmoid(logits)
    inter = torch.sum(p * labels, dim=(1, 2, 3))
    denom = torch.sum(p, dim=(1, 2, 3)) + torch.sum(labels, dim=(1, 2, 3))
    dice = 1.0 - torch.mean((2.0 * inter + 1.0) / (denom + 1.0))
    return bce + dice


# ----------------------------------------------------------------- train
def adamw(model, lr: float) -> torch.optim.AdamW:
    """`optax.adamw(lr)` over every parameter of `model`."""
    return torch.optim.AdamW(model.parameters(), lr=lr, **ADAMW)


def new_model(generator: torch.Generator, init_params=None,
              features=unet_mod.FEATURES) -> UNet:
    """A trainable UNet (float32 parameters, train mode) on the
    generator's device: from the flat Flax tree `init_params`, or drawn
    as Flax's `model.init` draws."""
    if init_params is not None:
        model = unet_mod.model_from_flat(init_params, serving=False)
        return model.to(generator.device)
    model = UNet(features).to(generator.device)
    unet_mod.init_flax_like(model, generator)
    return model


def train_step(model, optimizer, loss_fn, images, labels):
    """One optimiser step; the loss, still on the device."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, images, labels)
    loss.backward()
    optimizer.step()
    return loss.detach()


def replicas(model, mesh) -> list:
    """One copy of `model` per mesh device, in mesh order; the first is
    `model` itself, which must sit on the mesh's first device."""
    return [model] + [copy.deepcopy(model).to(dev) for dev in mesh.devices[1:]]


def mesh_step(models, optimizer, loss_fn, images, labels, mesh):
    """One data-parallel optimiser step over `mesh`, the JAX package's
    step under `NamedSharding(mesh, P(axis))`: the batch (on the first
    device) splits into contiguous equal shards along dim 0 (an uneven
    split raises, as `shard_bones` does), replica i takes shard i, and
    its loss is weighted by its share of the batch, so the shard
    gradients sum to the gradient of the full batch's mean loss.  They
    are summed in mesh order on the first device, where `optimizer` (over
    `models[0]`) takes one AdamW step, and the parameters are then copied
    to every other replica.  The shards run one after the other from this
    thread.  Each replica's bf16 weight gradient is rounded on its own,
    so a sharded step is close to the unsharded one but not equal to it;
    on a one-device mesh it is `train_step` bit for bit.  Returns the
    full batch's loss on the first device."""
    home = mesh.devices[0]
    shards = pmesh.shard_bones((images, labels), mesh)
    n = images.shape[0]
    optimizer.zero_grad(set_to_none=True)
    for model in models[1:]:
        model.zero_grad(set_to_none=True)
    loss = 0.0
    for model, (im, lb) in zip(models, shards):
        part = loss_fn(model, im, lb) * (im.shape[0] / n)
        part.backward()
        loss = loss + part.detach().to(home)
    with torch.no_grad():
        for p, *others in zip(*(m.parameters() for m in models)):
            for q in others:
                p.grad += q.grad.to(home)
    optimizer.step()
    with torch.no_grad():
        for p, *others in zip(*(m.parameters() for m in models)):
            for q in others:
                q.copy_(p)
    return loss


def train(
    steps: int = 500,
    batch: int = 8,
    size: int = 512,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 50,
    features=unet_mod.FEATURES,
    device=None,
    generator: torch.Generator | None = None,
    mesh=None,
):
    """Train on the procedural stream alone, plain BCE.  Returns the
    model and the losses of the logged steps.

    Every step is a `mesh_step` over `mesh` (a `parallel.mesh.BoneMesh`),
    by default the one-device mesh of `device` (the card when neither is
    given), which is the one-device step bit for bit.  The model is made
    and every batch drawn on the mesh's first device, from the one
    generator; `device`, if given with a mesh, must be that device.  The
    model returned is the first device's replica."""
    if mesh is None:
        mesh = pmesh.bone_mesh(["cuda" if device is None else device])
    home = mesh.devices[0]
    if device is not None and (torch.device(device).type, torch.device(
            device).index or 0) != (home.type, home.index or 0):
        raise ValueError(f"device {device} is not the mesh's first "
                         f"device {home}")
    generator = training_generator(generator, seed, home)
    model = new_model(generator, features=features)
    optimizer = adamw(model, lr)
    models = replicas(model, mesh)
    losses = []
    for i in range(steps):
        images, labels = synth_polar_batch(generator, batch, size)
        loss = mesh_step(models, optimizer, bce_loss, images, labels, mesh)
        if i % log_every == 0:
            losses.append(float(loss))
            print(f"[unet] step {i} loss {losses[-1]:.4f}", flush=True)
    return model, losses


def dryrun(mesh, batch: int = 8, image_size: int = 64) -> float:
    """One data-parallel training step over `mesh` on tiny shapes: a
    UNet of widths (4, 8) from seed 0, a procedural batch from seed 1,
    plain BCE, AdamW at 1e-3.  Returns the step's loss, read on the host
    (which waits for the step)."""
    dev = mesh.devices[0]
    model = new_model(training_generator(None, 0, dev), features=(4, 8))
    optimizer = adamw(model, 1e-3)
    images, labels = synth_polar_batch(training_generator(None, 1, dev),
                                       batch, image_size)
    return float(mesh_step(replicas(model, mesh), optimizer, bce_loss,
                           images, labels, mesh))


def mixture_counts(batch: int, frac_procedural: float):
    """(procedural, corpus) samples per step."""
    n_proc = max(1, int(round(batch * frac_procedural)))
    return n_proc, batch - n_proc


def mixture_batch(generator, corpus_images, corpus_masks, n_corp: int,
                  n_proc: int, size: int):
    """One training batch: `n_corp` corpus pairs, each under a random
    theta roll (the image axis is periodic) and 0.01 noise, then `n_proc`
    procedural pairs."""
    kw = dict(generator=generator, device=corpus_images.device)
    idx = torch.randint(0, corpus_images.shape[0], (n_corp,), **kw)
    ci = corpus_images[idx].to(torch.float32)
    cm = corpus_masks[idx].to(torch.float32)
    shift = torch.randint(0, size, (n_corp,), **kw)
    ci, cm = _roll_theta(ci, shift), _roll_theta(cm, shift)
    ci = ci + 0.01 * torch.randn(ci.shape, **kw)
    images, labels = ci[:, None], cm[:, None]
    if n_proc:
        pi, pm = synth_polar_batch(generator, n_proc, size)
        images = torch.cat([images, pi])
        labels = torch.cat([labels, pm])
    return images, labels


def train_mixture(
    corpus_images,
    corpus_masks,
    steps: int = 3000,
    batch: int = 16,
    size: int = 512,
    lr: float = 3e-4,
    seed: int = 0,
    frac_procedural: float = 0.25,
    boundary_amp: float = 4.0,
    log_every: int = 100,
    init_params=None,
    features=unet_mod.FEATURES,
    device="cuda",
    generator: torch.Generator | None = None,
):
    """Train on a mixture of pipeline-extracted corpus pairs and the
    procedural polar generator.

    The corpus (tools/make_unet_corpus_torch.py) carries the pipeline's
    true image distribution: groove-anchored roll, real normalization,
    neck windowing.  The procedural stream stays in the mix as an
    infinite-variety regularizer.  The whole corpus lives on the device
    as float16 and each step samples it there.

    `init_params`: a flat Flax tree to start from (`load_params`), else
    Flax-like random weights.  Returns the model and the losses of the
    logged steps (every `log_every`th and the last).
    """
    generator = training_generator(generator, seed, device)
    dev = generator.device
    model = new_model(generator, init_params, features)
    optimizer = adamw(model, lr)

    corpus_images = torch.as_tensor(np.asarray(corpus_images)).to(
        dev, torch.float16)
    corpus_masks = torch.as_tensor(np.asarray(corpus_masks)).to(
        dev, torch.float16)
    n_proc, n_corp = mixture_counts(batch, frac_procedural)

    def loss_fn(model, images, labels):
        return dice_bce_loss(model, images, labels, boundary_amp)

    losses = []
    for i in range(steps):
        images, labels = mixture_batch(generator, corpus_images,
                                       corpus_masks, n_corp, n_proc, size)
        loss = train_step(model, optimizer, loss_fn, images, labels)
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
            print(f"[unet] step {i} loss {losses[-1]:.4f}", flush=True)
    return model, losses


# ----------------------------------------------------------- checkpoint
def save_params(model: UNet, path) -> None:
    """Write the model's parameters as float32 to the npz `path` in the
    flat Flax layout, which `unet.load_model(device, path)` serves from
    and `load_params` reads back.  Models this process has already loaded
    are forgotten, so the next `load_model` reads the new file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        np.savez(fh, **convert.unet_flat_params(model.state_dict()))
    unet_mod._load_model.cache_clear()


def load_params(path=unet_mod.DEFAULT_NPZ):
    """The flat Flax tree of the npz `path`, or None when it is absent."""
    path = Path(path)
    if not path.exists():
        return None
    return unet_mod.load_flat(path)
