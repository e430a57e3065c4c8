"""The fused kernel's block walk, and its plain model `walk_ranked`.

csrc/slice_stack.cu walks each plane by list ranking (walk.cuh's
`walk_ranked`): pointer jumping over the predecessor map of a successor
map whose chains cannot merge.  Its plain model here, round for round,
must give exactly the serial walk (`chain_walk_plain`, and the Pallas
kernel in interpret mode on every row inside its contract): n, and order
and the loop-start marks at every position below n.  Cases: random loop
rows, rows built to break a list ranking (chains whose slots fall and
rise, cycles and paths with no slot below nc, self-loops with a
predecessor, one cycle over every slot, k = 1, empty rows), and every row
of the compaction of the tiny bone's three stacks, with a k that
overflows.  The kernel itself is held to the plain
walk on the card (tests/test_torch_cuda.py, chip_smoke.py phases 5, 9).
"""

import numpy as np
import pytest
import torch

from shoulder_tpu.ops import pallas_chain
from shoulder_tpu.utils import geometry as jgeom
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.ops import chain_walk
from shoulder_tpu_torch.ops import slicing as tsl

from test_pallas_chain import _random_case

CFG = tiny_config()


def walk_ranked(succ: torch.Tensor, nc: torch.Tensor):
    """The fused kernel's block walk (csrc/walk.cuh, `walk_ranked`) in
    plain PyTorch over (R, K) rows; it returns `chain_walk_plain`'s
    (order, n, is_start) for the rows whose crossed count is nc (R,).

    Each row's chains must not merge: every slot has at most one
    predecessor other than itself (asserted).  Successors outside [0, K)
    end a chain as a self-successor does.  The rounds follow the kernel:
    pointer jumping joins each slot's window of the slots behind it with
    the window at its far end, keeping the smallest key (a slot's own
    number below nc) and the distance from its nearest holder, until no
    window has a far end left or the windows span K slots (the kernel
    stops at its nv <= K valid slots; the windows of a cycle then cover it
    and further rounds change no key or distance).  Then each loop's last
    slot gives its length, an exclusive sum the loops' offsets, and a
    scatter the walk.
    """
    rows, k = succ.shape
    dev = succ.device
    slots = torch.arange(k, device=dev).expand(rows, k)
    s = succ.to(torch.int64)
    s = torch.where((s >= 0) & (s < k), s, slots)
    linked = s != slots
    indeg = torch.zeros((rows, k), dtype=torch.int64, device=dev)
    indeg.scatter_add_(1, s, linked.to(torch.int64))
    if bool((indeg > 1).any()):
        raise ValueError("walk_ranked needs chains that cannot merge: a slot "
                         "has two predecessors")
    pred = torch.full((rows, k + 1), -1, dtype=torch.int64, device=dev)
    pred.scatter_(1, torch.where(linked, s, k), slots)
    no_key = k
    far = pred[:, :k]                      # the window's far end, -1 none
    size = torch.ones((rows, k), dtype=torch.int64, device=dev)
    key = torch.where(slots < nc.to(torch.int64)[:, None], slots, no_key)
    dist = torch.zeros((rows, k), dtype=torch.int64, device=dev)
    rounds = 0
    while (1 << rounds) < k:
        rounds += 1
    for _ in range(rounds):
        has = far >= 0
        at = far.clamp(min=0)
        t_key, t_dist = key.gather(1, at), dist.gather(1, at)
        t_far, t_size = far.gather(1, at), size.gather(1, at)
        take = has & (t_key < key)         # a smaller key, farther back
        key = torch.where(take, t_key, key)
        dist = torch.where(take, t_dist + size, dist)
        size = torch.where(has, size + t_size, size)
        far = torch.where(has, t_far, far)
        if not bool((far >= 0).any()):
            break
    visited = key < no_key
    # each loop's last slot: its successor ends the chain or heads a loop
    last = visited & ((s == slots) | (dist.gather(1, s) == 0))
    length = torch.zeros((rows, k + 1), dtype=torch.int64, device=dev)
    length.scatter_(1, torch.where(last, key, k), dist + 1)
    length = length[:, :k]
    offset = torch.cumsum(length, dim=1) - length
    at = torch.where(visited, offset.gather(1, key.clamp(max=k - 1)) + dist,
                     k)
    order = torch.zeros((rows, k + 1), dtype=torch.int32, device=dev)
    order.scatter_(1, at, slots.to(torch.int32))
    is_start = torch.zeros((rows, k + 1), dtype=torch.bool, device=dev)
    is_start.scatter_(1, at, dist == 0)
    return (order[:, :k].contiguous(), length.sum(dim=1).to(torch.int32),
            is_start[:, :k].contiguous())


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


def _inside_nc(succ, crossed):
    """True where no slot below nc has its successor at or past nc: the
    Pallas kernel reads only slots below nc (its crossed faces link among
    themselves), the serial walk follows any successor in [0, K)."""
    return bool(((succ < crossed.sum(dim=1, keepdim=True))
                 | (crossed == 0)).all())


def _check(succ, nc):
    """walk_ranked against the plain walk and, where the row is inside
    its contract, the Pallas kernel."""
    succ = torch.as_tensor(succ, dtype=torch.int32)
    crossed = _front(nc, succ.shape[1])
    got = walk_ranked(succ, torch.as_tensor(nc))
    _assert_same(got, chain_walk.chain_walk_plain(succ, crossed))
    if _inside_nc(succ, crossed):
        _assert_same(got, pallas_chain.chain_walk_marked(
            succ.numpy(), crossed.numpy(), interpret=True))
    return got


@pytest.mark.parametrize("seed", range(3))
def test_random_loop_rows(seed):
    rng = np.random.default_rng(seed)
    k = 128
    cases = []
    for _ in range(6):
        sizes = rng.integers(1, 40, size=rng.integers(1, 8)).tolist()
        while sum(sizes) > k - 4:
            sizes = sizes[:-1]
        cases.append(_random_case(rng, k, len(sizes), sizes))
    succ = np.stack([c[0] for c in cases])
    _check(succ, [int(c[1].sum()) for c in cases])


def _row(k, chains, cycles=()):
    """A successor row of open chains (lists of slots in successor order,
    the last its own successor) and cycles."""
    succ = np.arange(k, dtype=np.int32)
    for ch in chains:
        succ[ch[:-1]] = ch[1:]
    for cy in cycles:
        succ[cy] = np.roll(cy, -1)
    return succ


ADVERSARIAL = {
    # heads split a chain wherever its slots reach a new low: 9 | 3 12 | 1 5 |
    # 0 14 7; the tail 14 7 joins 0's loop; 2 4 6 8 are loops of one
    "falls and rises": (_row(16, [[9, 3, 12, 1, 5, 0, 14, 7]]), 10),
    # no slot below nc: never visited, beside a visited cycle
    "cycle above nc": (_row(16, [], [[12, 13, 15], [4, 1, 8]]), 10),
    # 11 12 are never visited; 2 heads 2 13 4
    "path into and out of nc": (_row(16, [[11, 12, 2, 13, 4]]), 10),
    # 6 -> 8 with 8 its own successor; 3 alone; 5 -> 6 -> 8 from below
    "self-loop with a predecessor": (_row(16, [[5, 6, 8], [10, 3]]), 9),
    "one cycle of every slot": (_row(16, [], [[3, 7, 0, 12, 15, 1, 9, 4, 14,
                                                2, 11, 6, 13, 5, 10, 8]]), 16),
    "one cycle, heads below nc only": (_row(16, [], [[15, 3, 9, 0, 12, 7, 1,
                                                       14, 2, 11, 6, 13, 5,
                                                       10, 8, 4]]), 5),
    "empty row": (_row(16, [[1, 2, 3]], [[4, 5]]), 0),
}


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_rows(case):
    succ, nc = ADVERSARIAL[case]
    _check(succ[None], [nc])


def test_falls_and_rises_splits_the_chain():
    succ, nc = ADVERSARIAL["falls and rises"]
    order, n, start = walk_ranked(torch.as_tensor(succ[None]),
                                             torch.tensor([nc]))
    assert int(n) == 12
    assert order[0].tolist()[:12] == [0, 14, 7, 1, 5, 2, 3, 12, 4, 6, 8, 9]
    assert torch.nonzero(start[0]).flatten().tolist() == [0, 3, 5, 6, 8, 9,
                                                          10, 11]


def test_one_slot_rows():
    _check(np.zeros((2, 1), np.int32), [1, 0])


def test_merging_chains_are_refused():
    succ = torch.tensor([[2, 2, 2, 3]], dtype=torch.int32)  # 0 -> 2 <- 1
    with pytest.raises(ValueError, match="merge"):
        walk_ranked(succ, torch.tensor([4]))


@pytest.fixture(scope="module")
def tiny_sg(tiny_spec):
    s = tiny_spec
    v = np.asarray(jgeom.transform_pts(s.vertices,
                                       s.obb_transform.astype(np.float32)))
    return v, tsl.sorted_geom(*(torch.as_tensor(a) for a in (
        v, s.faces, s.neighbors, s.face_orig)))


@pytest.mark.parametrize("stack", ["full", "proximal", "distal", "k64"])
def test_compacted_rows_of_the_tiny_bone(tiny_sg, stack):
    """Every row of the compaction of one stack (its planes, and planes
    above, below and at vertex heights), after the injectivity rule, as
    slice_stack_plain walks them, against the serial walk and the Pallas
    kernel on every row; k 64 overflows on a few planes."""
    v, sg = tiny_sg
    sset = getattr(CFG, "full" if stack == "k64" else stack)
    zhi, zlo = float(v[:, 2].max()), float(v[:, 2].min())
    zv = np.sort(v[:, 2])[len(v) // 9:: len(v) // 7][:6]
    zs = torch.as_tensor(np.concatenate([
        np.linspace(0.99 * zhi, 0.99 * zlo, sset.zslice_num),
        [zhi + 5.0, zhi + 1e-3, zlo - 1e-3, zlo - 5.0], zv,
    ]).astype(np.float32))
    band = min(sset.band, sg.z_key.shape[0])
    k = 64 if stack == "k64" else min(CFG.slice_compact_k, band)
    crossed, _s, _e, succ, _o, over, _open = tsl.compact_stack(sg, zs, band,
                                                               k)
    succ = succ.to(torch.int32)
    assert _inside_nc(succ, crossed.to(torch.int32))
    got = _check(succ, crossed.sum(dim=1))
    assert int(got[1].sum()) > 10 * len(zs)
    if stack == "k64":
        assert int(over.sum()) >= 4
