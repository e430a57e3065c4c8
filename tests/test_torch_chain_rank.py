"""The standalone walk kernel's ranking, and its plain model `chain_rank`.

csrc/chain_walk.cu computes the serial walk's closed form on any
successor map, chains that merge included: slot v is visited in the loop
of the smallest live slot h < nc whose successor sequence reaches it, at
its distance from h.  Pointer jumping over the successors computes each
slot's (head, distance) pair.  Its plain model here, round for round,
must give exactly the serial walk (`chain_walk_plain`, and the Pallas
kernel in interpret mode on the rows inside that kernel's contract): n,
and order and the loop-start marks at every position below n.  Cases:
merging chains, cycles with cut edges, chains through slots at or past
nc, out-of-range and negative successors, k = 1, empty rows, and random
rows of every kind.  The kernel itself is held to the plain walk on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""

import numpy as np
import pytest
import torch

from shoulder_tpu.ops import pallas_chain
from shoulder_tpu_torch.ops import chain_walk

from test_torch_cuda import _merging_rows

NONE = 1 << 40  # no head reaches the slot


def chain_rank(succ: torch.Tensor, nc: torch.Tensor):
    """The walk kernel's rounds (csrc/chain_walk.cu) in plain PyTorch over
    (R, K) rows: `chain_walk_plain`'s (order, n, is_start) for the rows
    whose crossed count is nc (R,), and the rounds taken.

    f(v) is v's successor where the walk may step to it (in [0, K), not v
    itself, its own successor not negative).  Each live slot below nc
    starts with the pair (itself, 0), head << 16 | distance; round r moves
    every pair 2^r slots on along f, its distance plus 2^r, and keeps the
    smallest pair at each slot, and doubles each slot's jump.  The rounds
    stop after the first that improves no pair, or after ceil(log2 K).
    Then each loop's length is its largest distance plus one, its offset
    the exclusive sum of the lengths in head order, and each slot's
    position its loop's offset plus its distance.
    """
    rows, k = succ.shape
    dev = succ.device
    slots = torch.arange(k, device=dev).expand(rows, k)
    s = succ.to(torch.int64)
    live = s >= 0
    inside = live & (s < k)
    step = inside & (s != slots) & live.gather(1, s.clamp(0, k - 1))
    jump = torch.where(step, s, -1)
    nc = nc.to(torch.int64)[:, None]
    pair = torch.where(live & (slots < nc), slots << 16, NONE)
    rounds = 0
    while (1 << rounds) < k:
        has = (jump >= 0) & (pair != NONE)
        at = jump.clamp(min=0)
        moved = pair + (1 << rounds)
        improves = has & (moved < pair.gather(1, at))
        new = torch.cat([pair, torch.full((rows, 1), NONE, device=dev)], 1)
        new.scatter_reduce_(1, torch.where(has, jump, k), moved, reduce="amin")
        pair = new[:, :k]
        jump = torch.where(jump >= 0, jump.gather(1, at), -1)
        rounds += 1
        if not bool(improves.any()):
            break
    visited = pair != NONE
    head = torch.where(visited, pair >> 16, k)
    dist = pair & 0xFFFF
    length = torch.zeros((rows, k + 1), dtype=torch.int64, device=dev)
    length.scatter_reduce_(1, head, torch.where(visited, dist + 1, 0),
                           reduce="amax")
    length = length[:, :k]
    offset = torch.cumsum(length, dim=1) - length
    pos = torch.where(visited, offset.gather(1, head.clamp(max=k - 1)) + dist,
                      k)
    order = torch.zeros((rows, k + 1), dtype=torch.int32, device=dev)
    order.scatter_(1, pos, slots.to(torch.int32))
    is_start = torch.zeros((rows, k + 1), dtype=torch.bool, device=dev)
    is_start.scatter_(1, pos, visited & (dist == 0))
    return (order[:, :k].contiguous(), length.sum(dim=1).to(torch.int32),
            is_start[:, :k].contiguous()), rounds


def _front(nc, k):
    """crossed (R, K) int32 with the first nc[r] slots of each row set."""
    return (torch.arange(k)[None] < torch.as_tensor(nc)[:, None]).to(
        torch.int32)


def _assert_same(got, want):
    g_order, g_n, g_start = got
    w_order, w_n, w_start = (torch.as_tensor(np.array(x)) for x in want)
    w_n = w_n.reshape(-1).to(torch.int32)
    assert torch.equal(g_n, w_n)
    for r, n in enumerate(w_n.tolist()):
        assert torch.equal(g_order[r, :n], w_order[r, :n].to(torch.int32)), r
        assert torch.equal(g_start[r, :n], w_start[r, :n]), r


def _inside_pallas(succ, nc):
    """Rows inside the Pallas kernel's contract: it reads only slots below
    nc, so every slot there must have its successor in [0, nc)."""
    below = torch.arange(succ.shape[1])[None] < nc[:, None]
    return ((~below) | ((succ >= 0) & (succ < nc[:, None]))).all(dim=1)


def _check(succ, nc):
    """chain_rank against the plain walk on every row and the Pallas
    kernel on the rows inside its contract; returns (rows held against
    the Pallas kernel, rounds taken)."""
    succ = torch.as_tensor(succ, dtype=torch.int32)
    nc = torch.as_tensor(nc, dtype=torch.int64)
    crossed = _front(nc, succ.shape[1])
    got, rounds = chain_rank(succ, nc)
    _assert_same(got, chain_walk.chain_walk_plain(succ, crossed))
    inside = _inside_pallas(succ, nc)
    if bool(inside.any()):
        _assert_same(tuple(x[inside] for x in got),
                     pallas_chain.chain_walk_marked(
                         succ[inside].numpy(), crossed[inside].numpy(),
                         interpret=True))
    assert rounds <= max(1, int(np.ceil(np.log2(max(succ.shape[1], 2)))))
    return int(inside.sum()), rounds


def _row(k, chains=(), cycles=(), cut=()):
    """A successor row of open chains (lists of slots in successor order,
    the last its own successor unless cut), cycles, and (slot, successor)
    cuts applied last."""
    succ = np.arange(k, dtype=np.int32)
    for ch in chains:
        succ[ch[:-1]] = ch[1:]
    for cy in cycles:
        succ[cy] = np.roll(cy, -1)
    for slot, to in cut:
        succ[slot] = to
    return succ


CASES = {
    # 0 -> 2 <- 1, 2 -> 3: 1 heads a loop of itself only
    "two chains merge": (_row(6, cut=[(0, 2), (1, 2), (2, 3)]), 6),
    # 4 and 5 run into the cycle 0 1 2 3 at 2 and 0
    "chains into a cycle": (_row(8, cycles=[[0, 1, 2, 3]],
                                 cut=[(4, 2), (5, 0)]), 8),
    # the smaller head reaches the join later than the larger one
    "late join": (_row(10, chains=[[0, 6, 7, 8, 9, 3], [3, 4]],
                       cut=[(2, 3)]), 5),
    # every slot points at slot 3, itself a self-successor
    "star": (np.full(8, 3, np.int32), 8),
    # a chain leaves nc through 7 and 9 and comes back to 2
    "through slots past nc": (_row(12, chains=[[0, 7, 9, 2, 1]]), 5),
    # 1 -> 12 and 3 -> 40 leave the row; 5 -> -1 reaches a dead end
    "out of range": (_row(8, chains=[[0, 1], [2, 3]],
                          cut=[(1, 12), (3, 40), (4, 5), (5, -1)]), 8),
    # 2 is dead (its own successor negative): it heads nothing and ends
    # the walks from 0 and 3 at 1 and 4
    "negative successor": (_row(6, cut=[(0, 1), (1, 2), (2, -3), (4, 2),
                                        (3, 4)]), 6),
    "cycle with a cut edge": (_row(9, cycles=[[0, 5, 2, 7, 3]],
                                   cut=[(7, 7)]), 9),
    "empty row": (_row(8, chains=[[1, 2, 3]], cycles=[[4, 5]]), 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cases(case):
    succ, nc = CASES[case]
    _check(succ[None], [nc])


def test_one_slot_rows():
    _check(np.array([[0], [-1], [3], [0]], np.int32), [1, 1, 1, 0])


def test_late_join_takes_the_smaller_head():
    """0 reaches 3 at distance 5, 2 at distance 1: 3 and 4 join 0's loop,
    and 2 heads a loop of itself."""
    succ, nc = CASES["late join"]
    (order, n, start), _ = chain_rank(torch.as_tensor(succ[None]),
                                      torch.tensor([nc]))
    assert int(n) == 9
    assert order[0, :9].tolist() == [0, 6, 7, 8, 9, 3, 4, 1, 2]
    assert torch.nonzero(start[0]).flatten().tolist() == [0, 7, 8]


@pytest.mark.parametrize("k", [1, 2, 7, 40, 384])
def test_random_rows(k):
    """Random maps (merging), permutations with cut edges, out-of-range
    and negative successors, any nc; the Pallas kernel on the rows inside
    its contract (random loops over the first nc slots among them)."""
    n_rows = 600 if k <= 40 else 64
    succ, crossed = _merging_rows(k, k, n_rows)
    nc = crossed.sum(axis=1)
    # loop rows inside the Pallas kernel's contract: a permutation of
    # the first nc slots
    rng = np.random.default_rng(100 + k)
    for r in range(0, n_rows, 4):
        succ[r] = np.arange(k)
        succ[r, :nc[r]] = rng.permutation(nc[r])
    inside, rounds = _check(succ, nc)
    assert inside >= n_rows // 4
    if k >= 40:
        assert rounds >= 2
