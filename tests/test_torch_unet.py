"""The port's UNet vs the Flax UNet, and the exported weights vs the
orbax checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shoulder_tpu.models import unet as junet
from shoulder_tpu.models import unet_train
from shoulder_tpu_torch.models import convert
from shoulder_tpu_torch.models import unet as tunet


@pytest.fixture(scope="module")
def flax_params():
    return unet_train.load_params()


def _polar_like_image(seed, h=512, w=512):
    """A smooth polar-radius-like image in [0, 1]: radius falling from the
    head down the rows, with low-order theta harmonics."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = 0.6 * (1 - yy) ** 1.5 + 0.1 * np.sin(
        2 * np.pi * (xx + rng.random())) * (1 - yy)
    for kx in range(1, 4):
        img += 0.03 * rng.standard_normal() * np.sin(
            2 * np.pi * kx * xx + 6 * rng.random()) * np.cos(np.pi * kx * yy)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def test_unet_npz_equals_orbax_checkpoint(flax_params):
    with np.load(tunet.DEFAULT_NPZ) as z:
        flat = {k: z[k] for k in z.files}
    leaves = jax.tree_util.tree_leaves_with_path(flax_params)
    assert len(flat) == len(leaves) == 64
    for path, leaf in leaves:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        assert np.array_equal(flat[key], np.asarray(leaf)), key


def test_converted_state_dict_fills_every_parameter():
    with np.load(tunet.DEFAULT_NPZ) as z:
        state = convert.unet_state_dict({k: z[k] for k in z.files})
    model = tunet.UNet()
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)          # strict: shapes must agree
    assert sum(v.numel() for v in state.values()) == 483153


def test_converted_unet_matches_flax(flax_params):
    """One 512x512 image: mask agreement >= 99.5%.

    Both compute the convolutions in bfloat16, rounding at different
    places (measured on the CPU: 99.80% agreement; in float32 the two
    architectures agree to 3e-4 in the logits), so masks are compared by
    pixel agreement, not bit for bit.
    """
    img = _polar_like_image(0)
    ref = np.asarray(junet.segment_image(flax_params, jnp.asarray(img)))
    got = tunet.segment_image(tunet.load_model("cpu"),
                              torch.as_tensor(img)).numpy()
    assert got.shape == ref.shape == img.shape
    assert 0.005 < ref.mean() < 0.5
    assert (got == ref).mean() >= 0.995
