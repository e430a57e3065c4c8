"""Contour-chain walk: CUDA kernel, wrapper and plain version.

The counterpart of shoulder_tpu/ops/pallas_chain.py (the Pallas TPU
kernel `_walk_kernel` behind `chain_walk_marked`).  The kernel is
csrc/chain_walk.cu, part of the port's one kernel library
(ops/kernels.py: nvcc for sm_90a at first use, bound through ctypes).  It
computes the serial walk's closed form by pointer jumping, one thread
block per row: each slot's loop head is the smallest slot below nc that
reaches it, its position the head's offset plus its distance
(tests/test_torch_chain_rank.py holds the rounds' plain model).
The main path's slice stacks walk inside the fused slice-stack kernel
(csrc/slice_stack.cu); this entry point is the walk on its own.

Contract, for (R, K) int32 `succ` and `crossed` (crossed faces packed at
the front of each row): walk every contour loop of every row in successor
direction, loops in order of their smallest unvisited slot below
nc = sum(crossed).  Returns order (R, K) int32, the face at each walk
position; n (R,) int32, the faces visited; is_start (R, K) bool, true
where a position begins a loop.  Positions at or past n hold 0 / False.

Successor values outside [0, K) end a loop; a slot whose own successor is
negative counts as visited from the start.  Any map is taken, chains that
merge included.

`chain_walk_marked` runs the plain PyTorch walk (the serial walk, one
step for every row at once) for a tensor on the CPU and the CUDA kernel
for a tensor on the card; it never falls back from one to the other.
The recorder's counter `launches.chain_walk` (utils/trace.py) counts
kernel launches.

The fused kernel walks by list ranking instead (walk.cuh's `walk_ranked`,
the whole block at once, over the predecessor map), which gives the same
walk wherever chains cannot merge, as its injectivity stage ensures
(tests/test_torch_walk_ranked.py holds its plain model).
"""

from __future__ import annotations

import torch

from shoulder_tpu_torch.ops import kernels
from shoulder_tpu_torch.utils import trace


def chain_walk_marked(succ: torch.Tensor, crossed: torch.Tensor):
    """Walk all loops of every row: (order (R,K), n (R,), is_start (R,K)).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if succ.dim() != 2 or succ.shape != crossed.shape:
        raise ValueError(f"succ {tuple(succ.shape)} and crossed "
                         f"{tuple(crossed.shape)} must be one (R, K) shape")
    if succ.device != crossed.device:
        raise ValueError("succ and crossed must be on one device")
    if succ.device.type == "cpu":
        return chain_walk_plain(succ, crossed)
    if succ.device.type != "cuda":
        raise ValueError(f"no chain walk for device {succ.device}")
    if succ.dtype != torch.int32 or crossed.dtype != torch.int32:
        raise TypeError("succ and crossed must be int32")
    if not (succ.is_contiguous() and crossed.is_contiguous()):
        raise ValueError("succ and crossed must be contiguous")
    rows, k = succ.shape
    lib = kernels.library()
    if k > lib.chain_walk_max_k():
        raise ValueError(f"row width {k} exceeds the kernel's "
                         f"{lib.chain_walk_max_k()}")
    order = torch.empty((rows, k), dtype=torch.int32, device=succ.device)
    is_start = torch.empty((rows, k), dtype=torch.bool, device=succ.device)
    n = torch.empty((rows,), dtype=torch.int32, device=succ.device)
    stream = torch.cuda.current_stream(succ.device)
    rc = lib.chain_walk_launch(
        succ.data_ptr(), crossed.data_ptr(), order.data_ptr(),
        is_start.data_ptr(), n.data_ptr(), rows, k, succ.device.index or 0,
        stream.cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"chain_walk kernel launch failed: CUDA error {rc}")
    trace.count("launches.chain_walk")
    return order, n, is_start


def chain_walk_plain(succ: torch.Tensor, crossed: torch.Tensor):
    """The walk in plain PyTorch, one step for every row at once.

    Each iteration either starts a row's next loop at its smallest
    unvisited slot below nc or advances along the loop it is on, so a
    row finishes after n + 1 iterations: at most K + 1 in all.
    """
    rows, k = succ.shape
    dev = succ.device
    r_idx = torch.arange(rows, device=dev)
    slots = torch.arange(k, device=dev)
    # column k of each buffer is a dump slot for rows that write nothing
    work = torch.full((rows, k + 1), -1, dtype=torch.int64, device=dev)
    work[:, :k] = succ.to(torch.int64)
    order = torch.zeros((rows, k + 1), dtype=torch.int32, device=dev)
    is_start = torch.zeros((rows, k + 1), dtype=torch.bool, device=dev)
    n = torch.zeros(rows, dtype=torch.int64, device=dev)
    nc = crossed.to(torch.int64).sum(dim=1)
    head = torch.zeros(rows, dtype=torch.int64, device=dev)  # next candidate
    cur = torch.full((rows,), -1, dtype=torch.int64, device=dev)
    for _ in range(k + 1):
        # rows between loops start the next one at their first unvisited
        # slot in [head, nc)
        seeking = cur < 0
        cand = ((slots >= head[:, None]) & (slots < nc[:, None])
                & (work[:, :k] >= 0))
        found = cand.any(dim=1)
        first = torch.argmax(cand.to(torch.int8), dim=1)
        starts = seeking & found
        cur = torch.where(starts, first, cur)
        head = torch.where(starts, first + 1, head)
        active = cur >= 0
        if not bool(active.any()):
            break
        c = cur.clamp(min=0)
        nxt = work[r_idx, c]
        dest = torch.where(active, n, k)[:, None]
        order.scatter_(1, dest, c.to(torch.int32)[:, None])
        is_start.scatter_(1, dest, starts[:, None])
        work.scatter_(1, torch.where(active, c, k)[:, None],
                      torch.full((rows, 1), -1, dtype=torch.int64, device=dev))
        n = n + active.to(torch.int64)
        nxt_c = nxt.clamp(0, k)
        ok = (nxt >= 0) & (nxt < k) & (work[r_idx, nxt_c] >= 0)
        cur = torch.where(active, torch.where(ok, nxt, -1), cur)
    return order[:, :k].contiguous(), n.to(torch.int32), \
        is_start[:, :k].contiguous()

