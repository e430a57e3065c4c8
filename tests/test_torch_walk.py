"""The port's contour-chain walk vs the Pallas walk (interpret mode).

The plain PyTorch walk must reproduce shoulder_tpu's Pallas kernel
exactly: the visit count n, and order and the loop-start marks at every
position below n (positions at or past n are unspecified in the Pallas
contract).  The CUDA kernel is held to the plain walk on the card.
"""

import jax
import numpy as np
import pytest
import torch

from shoulder_tpu.ops import pallas_chain
from shoulder_tpu_torch.ops import chain_walk

from test_pallas_chain import _random_case


def _random_rows(seed, k=128, n_rows=6):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_rows):
        sizes = rng.integers(3, 30, size=rng.integers(1, 4)).tolist()
        while sum(sizes) > k - 4:
            sizes = sizes[:-1]
        cases.append(_random_case(rng, k, len(sizes), sizes))
    return (np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases]))


def _assert_same_walk(jax_out, torch_out):
    j_order, j_n, j_start = map(np.asarray, jax_out)
    t_order, t_n, t_start = (x.numpy() for x in torch_out)
    j_n = j_n.reshape(-1)
    assert np.array_equal(t_n, j_n)
    for r, n in enumerate(j_n):
        assert np.array_equal(t_order[r, :n], j_order[r, :n]), f"row {r}"
        assert np.array_equal(t_start[r, :n], j_start[r, :n]), f"row {r}"


@pytest.mark.parametrize("seed", range(4))
def test_plain_walk_matches_pallas(seed):
    succ, crossed = _random_rows(seed)
    ref = pallas_chain.chain_walk_marked(succ, crossed, interpret=True)
    got = chain_walk.chain_walk_marked(torch.as_tensor(succ),
                                       torch.as_tensor(crossed))
    _assert_same_walk(ref, got)


def test_plain_walk_empty_slice():
    succ = np.arange(64, dtype=np.int32)[None].repeat(8, 0)
    crossed = np.zeros((8, 64), np.int32)
    ref = pallas_chain.chain_walk_marked(succ, crossed, interpret=True)
    got = chain_walk.chain_walk_marked(torch.as_tensor(succ),
                                       torch.as_tensor(crossed))
    assert (got[1] == 0).all()
    _assert_same_walk(ref, got)


def test_plain_walk_matches_pallas_batched_rows():
    """A (B, S, K) bone batch walked by the vmapped Pallas kernel equals
    the port's walk of the same rows folded to (B*S, K)."""
    rng = np.random.default_rng(7)
    k = 64
    cases = [_random_case(rng, k, 2, [5, 9]) for _ in range(6)]
    succ = np.stack([c[0] for c in cases]).reshape(2, 3, k)
    crossed = np.stack([c[1] for c in cases]).reshape(2, 3, k)
    ref = jax.vmap(lambda s, c: pallas_chain.chain_walk_marked(
        s, c, interpret=True))(succ, crossed)
    ref = tuple(np.asarray(x).reshape((6,) + x.shape[2:]) for x in ref)
    got = chain_walk.chain_walk_marked(torch.as_tensor(succ.reshape(6, k)),
                                       torch.as_tensor(crossed.reshape(6, k)))
    _assert_same_walk(ref, got)


def test_plain_walk_self_loops_and_past_n():
    """Self-successors dead-end at once (each is a loop of one); positions
    past n are zero / False."""
    succ = torch.tensor([[0, 2, 1, 3, 4, 5]], dtype=torch.int32)
    crossed = torch.tensor([[1, 1, 1, 1, 0, 0]], dtype=torch.int32)
    order, n, is_start = chain_walk.chain_walk_marked(succ, crossed)
    assert n.tolist() == [4]
    assert order[0, :4].tolist() == [0, 1, 2, 3]
    assert is_start[0].tolist() == [True, True, False, True, False, False]
    assert order[0, 4:].tolist() == [0, 0]


def test_wrapper_takes_plain_version_on_cpu():
    before = chain_walk.launch_count
    succ, crossed = (torch.as_tensor(a) for a in _random_rows(0))
    chain_walk.chain_walk_marked(succ, crossed)
    assert chain_walk.launch_count == before
    with pytest.raises(ValueError):
        chain_walk.chain_walk_marked(succ, crossed[:, :-1])
