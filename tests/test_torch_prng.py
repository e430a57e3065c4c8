"""The port's numpy threefry draw vs jax.random, bit for bit.

The sphere segmenter's RANSAC quadruples are
`jax.random.randint(PRNGKey(17), (128, 4), 0, top_n)` in the JAX package;
the port reproduces them without JAX (utils/jax_prng.py).  top_n is
4096 at tiny_config and int(0.4 * 512) * 512 = 104448 at DEFAULT_CONFIG,
where randint's uint32 multiplier square wraps (span > 65536).
"""

import jax
import numpy as np
import pytest

from shoulder_tpu_torch.models import segment
from shoulder_tpu_torch.utils import jax_prng


def _jax_randint(n):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(17), (128, 4),
                                         0, n))


def test_reference_uses_partitionable_threefry():
    """The port follows the partitionable counter layout; if a JAX
    release flips the flag, this fails instead of the draws drifting."""
    assert jax.config.jax_threefry_partitionable is True
    key = jax.random.PRNGKey(17)
    ours = jax_prng.prng_key(17)
    assert np.array_equal(np.asarray(key), np.asarray(ours, np.uint32))
    assert np.array_equal(np.asarray(jax.random.split(key, 3)),
                          jax_prng.split(ours, 3))
    assert np.array_equal(np.asarray(jax.random.bits(key, (5, 7))),
                          jax_prng.random_bits(ours, (5, 7)))


@pytest.mark.parametrize("n", [1, 7, 100, 4096, 65537, 104448, 122880,
                               1048579])
def test_randint_equals_jax(n):
    got = jax_prng.randint(17, (128, 4), 0, n)
    want = _jax_randint(n)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [4096, 104448])
def test_ransac_indices_equal_jax(n):
    idx = segment.ransac_indices(n, "cpu")
    assert idx.shape == (128, 4) and str(idx.dtype) == "torch.int64"
    assert np.array_equal(idx.numpy(), _jax_randint(n))
