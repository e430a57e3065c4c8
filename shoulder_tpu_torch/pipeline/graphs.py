"""CUDA graphs over the stages of a landmark batch.

`landmarks.landmarks_batch` opens a `batch(...)` keyed by its arguments
(the bones' shapes, dtypes and device, the config and the other values)
and by the identity of the parameter sets it reads (the forest and the
UNet), which the key keeps alive and every graph reads in place.  Inside
it, each stage function decorated `graphed` is keyed by its place in the
batch's order of calls, the function, and its own arguments (each
tensor's shape, stride, dtype and device, through named tuples; every
other argument by value, or by identity where it has none, the object
kept alive by the entry).  The first call with a key runs the stage
eagerly on a side stream (its result, and the warm-up a capture needs),
captures it into the memory pool that every stage of the batch's key
shares (capture order is replay order), and returns the eager result in
the capture's output buffers, so the card runs each kernel once in that
call too.  Later calls copy each tensor argument into the capture's own
input buffer (no copy where the argument already is the buffer a
previous stage returned) and replay it.  The batch's results are copied
out of the pool (`Batch.outputs`), so a caller's result from one call
survives the next.

A stage runs eagerly, exactly as without this module, unless every
tensor argument is on the batch's CUDA device, no CUDA graph capture is
under way on the stream, no `TorchDispatchMode` is active (so
`utils/nan_trap.py` sees every op), and no argument requires grad.  Off
a CUDA device no batch engages.  A capture that fails leaves its key eager for
the rest of the process; it warns once and counts `graphs.fallbacks`.
At most `MAX_BATCHES` batch keys are kept; opening another frees the
oldest key's graphs and pool.

Every replay runs inside the dispatcher op `shoulder_tpu_torch::
replay_graph`, so a profiler ties the replayed kernels to the range
around the stage as it ties eager kernels to their ops (a bare
`CUDAGraph.replay()` under a `record_function` range leaves the range
with no device time).  A replay calls none of the port's kernel
wrappers, so their launch counters (`launches.*` in `utils/trace.py`)
count the host's launches: the eager runs and the captures, not the
replays.  Counters: `graphs.captures`, `graphs.replays`, `graphs.eager`
(stage calls inside a batch on a CUDA device that ran eagerly: first
calls, ineligible calls, fallbacks) and `graphs.fallbacks`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import warnings

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import _get_current_dispatch_mode

from shoulder_tpu_torch.utils import trace

MAX_BATCHES = 4
COUNTERS = ("graphs.captures", "graphs.replays", "graphs.eager",
            "graphs.fallbacks")

_local = threading.local()  # .batch: the open Batch; .depth: inside a capture
_lock = threading.Lock()
_ids = itertools.count()
_graphs: dict[int, torch.cuda.CUDAGraph] = {}  # what the replay op replays
_side: dict[torch.device, torch.cuda.Stream] = {}
_op_lib = None


def _replay_op():
    """The dispatcher op that replays graph `key` (defined once)."""
    global _op_lib
    if _op_lib is None:
        lib = torch.library.Library("shoulder_tpu_torch", "DEF")
        lib.define("replay_graph(Tensor token, int key) -> ()")
        lib.impl("replay_graph", lambda token, key: _graphs[key].replay(),
                 "CompositeExplicitAutograd")
        _op_lib = lib
    return torch.ops.shoulder_tpu_torch.replay_graph


def _value_key(x, keep: list):
    """A key part for one leaf that is not a tensor: the value where it
    hashes, else the object's identity (the object appended to `keep`)."""
    try:
        hash(x)
    except TypeError:
        keep.append(x)
        return ("id", type(x).__qualname__, id(x))
    return (type(x).__qualname__, x)


def signature(tree, keep: list) -> tuple:
    """The key of a tree of arguments: its structure, each tensor's shape,
    stride, dtype and device, every other leaf by value or identity."""
    leaves, spec = _pytree.tree_flatten(tree)
    parts = [_value_key(spec, keep)]
    for x in leaves:
        if torch.is_tensor(x):
            parts.append(("tensor", tuple(x.shape), x.stride(), x.dtype,
                          x.device))
        else:
            parts.append(_value_key(x, keep))
    return tuple(parts)


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def eager_reason(leaves, device: torch.device) -> str | None:
    """Why a stage with these argument leaves must run eagerly on
    `device`, or None where it may be captured and replayed."""
    if device.type != "cuda":
        return "device"
    return _unfit(leaves, device)


def _unfit(leaves, device: torch.device) -> str | None:
    """eager_reason's cases that hold on any device."""
    if _get_current_dispatch_mode() is not None:
        return "dispatch mode"
    if _capturing(device):
        return "capture under way"
    grad = torch.is_grad_enabled()
    for x in leaves:
        if torch.is_tensor(x):
            if x.device != device:
                return "device"
            if grad and x.requires_grad:
                return "grad"
        elif grad and isinstance(x, torch.nn.Module) and any(
                p.requires_grad for p in x.parameters()):
            return "grad"
    return None


def _dims(x) -> list:
    """x's (stride, size) of each dimension longer than 1, by stride."""
    return sorted((s, n) for n, s in zip(x.shape, x.stride()) if n != 1)


def _dense(x) -> bool:
    """Whether x's elements fill its memory once each, in some order of
    its dimensions (so a buffer of its strides holds a copy of it)."""
    expected = 1
    for stride, size in _dims(x):
        if stride != expected:
            return False
        expected *= size
    return True


def _overlaps(x) -> bool:
    """Whether two of x's elements share memory (an expanded view)."""
    reach = 0
    for stride, size in _dims(x):
        if stride <= reach:
            return True
        reach += stride * (size - 1)
    return False


def _buffer(x):
    """A buffer of x's shape and strides on its device, holding a copy of
    x; None where two of x's elements share memory (an expanded view,
    which no copy can be written into)."""
    if _overlaps(x):
        return None
    reach = sum(stride * (size - 1) for stride, size in _dims(x))
    if _dense(x):
        buf = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                  device=x.device)
    else:
        base = torch.empty(reach + 1, dtype=x.dtype, device=x.device)
        buf = base.as_strided(x.shape, x.stride())
    return buf.copy_(x)


def _fill(dst, src) -> bool:
    """Copy src into dst, a tensor of its shape and strides, once per
    memory location (an expanded dimension at its first index); False
    where that cannot be done."""
    if dst is src:
        return True
    if (not torch.is_tensor(src) or dst.shape != src.shape
            or dst.stride() != src.stride() or dst.dtype != src.dtype):
        return False
    first = tuple(slice(0, 1) if s == 0 else slice(None)
                  for s in dst.stride())
    dst, src = dst[first], src[first]
    if _overlaps(dst):
        return False
    dst.copy_(src)
    return True


class _Graph:
    """One captured stage: the graph, its input buffers (each leaf: the
    buffer, and whether it is a buffer of the batch read in place), its
    outputs and the objects it reads."""

    def __init__(self, sig, graph=None, inputs=(), outs=(), spec=None,
                 keep=(), token=None):
        self.sig, self.graph = sig, graph
        self.inputs, self.outs, self.spec = inputs, outs, spec
        self.keep, self.token = keep, token
        self.id = next(_ids)
        if graph is not None:
            _graphs[self.id] = graph

    def close(self) -> None:
        _graphs.pop(self.id, None)
        self.graph = None

    def replay(self, leaves):
        """Copy the arguments in and replay; None where an argument that
        the capture read in place is no longer that buffer."""
        for (buf, in_place), x in zip(self.inputs, leaves):
            if not torch.is_tensor(buf) or x is buf:
                continue
            if in_place:
                if (x.data_ptr() != buf.data_ptr() or x.shape != buf.shape
                        or x.stride() != buf.stride()):
                    return None
                continue
            buf.copy_(x)
        _replay_op()(self.token, self.id)
        trace.count("graphs.replays")
        return _pytree.tree_unflatten(list(self.outs), self.spec)


class Batch:
    """The graphs of one `landmarks_batch` key on one device: each stage
    call's capture by its place in the order of calls, the memory pool
    they share, and the buffers they hold or read in place (the
    parameter sets' tensors among them)."""

    def __init__(self, device: torch.device, keep: list, params=()):
        self.device, self.keep = device, keep
        self.pool = self.token = None
        self.stages: dict[int, _Graph] = {}
        self.staged: list = []    # the batch's own input buffers
        self.owned: dict = {}     # storage address -> buffer it holds
        self.index = 0
        self.busy = False
        for t in _pytree.tree_leaves(params):
            self._own(t)

    def close(self) -> None:
        for g in self.stages.values():
            g.close()
        self.stages.clear()
        self.staged.clear()
        self.owned.clear()

    def _own(self, t) -> None:
        if torch.is_tensor(t):
            self.owned[t.untyped_storage().data_ptr()] = t

    def _owns(self, t) -> bool:
        return (torch.is_tensor(t)
                and t.untyped_storage().data_ptr() in self.owned)

    def inputs(self, tree):
        """`tree` with each tensor copied into a buffer of the batch's own
        (the same buffers at every call), so stages read the batch's
        arguments in place; as it is where a tensor is not dense."""
        leaves, spec = _pytree.tree_flatten(tree)
        if any(torch.is_tensor(x) and not _dense(x) for x in leaves):
            return tree
        if len(self.staged) != len(leaves):
            self.staged = [torch.empty_strided(x.shape, x.stride(),
                                               dtype=x.dtype,
                                               device=self.device)
                           if torch.is_tensor(x) else None for x in leaves]
            for b in self.staged:
                self._own(b)
        out = []
        for x, b in zip(leaves, self.staged):
            if torch.is_tensor(x):
                b.copy_(x)
                out.append(b)
            else:
                out.append(x)
        return _pytree.tree_unflatten(out, spec)

    def outputs(self, tree):
        """`tree` with each tensor that lives in a buffer of the batch
        cloned, so the next call cannot overwrite it."""
        return _pytree.tree_map(
            lambda x: x.clone() if self._owns(x) else x, tree)

    def call(self, fn, args, kwargs):
        leaves, spec = _pytree.tree_flatten((args, kwargs))
        slot = self.index
        self.index += 1
        if eager_reason(leaves, self.device) is not None:
            trace.count("graphs.eager")
            return fn(*args, **kwargs)
        keep: list = []
        sig = (fn, signature((args, kwargs), keep))
        entry = self.stages.get(slot)
        if entry is not None and entry.sig != sig:
            entry.close()
            entry = None
        if entry is None:
            return self._capture(slot, sig, fn, args, kwargs, leaves, spec,
                                 keep)
        if entry.graph is not None:
            out = entry.replay(leaves)
            if out is not None:
                return out
        trace.count("graphs.eager")
        return fn(*args, **kwargs)

    def _capture(self, slot, sig, fn, args, kwargs, leaves, spec, keep):
        """The stage's first call at its key: run eagerly on the capture's
        own inputs, captured, and the eager result copied into the
        capture's outputs."""
        dev = self.device
        inputs = []
        for x in leaves:
            if not torch.is_tensor(x):
                inputs.append((x, None))
            elif self._owns(x):
                inputs.append((x, True))
            elif (buf := _buffer(x)) is not None:
                inputs.append((buf, False))
            else:
                self.stages[slot] = _Graph(sig)
                trace.count("graphs.eager")
                return fn(*args, **kwargs)
        s_args, s_kwargs = _pytree.tree_unflatten([b for b, _ in inputs],
                                                  spec)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.token = torch.empty(0, device=dev)
        side = _side.get(dev)
        if side is None:
            side = _side[dev] = torch.cuda.Stream(dev)
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(dev)
        filled = False
        _local.depth = getattr(_local, "depth", 0) + 1
        try:
            side.wait_stream(cur)
            with torch.cuda.device(dev), torch.cuda.stream(side):
                # the call's eager run, and the capture's warm-up (lazy
                # state, workspaces)
                eager = fn(*s_args, **s_kwargs)
                side.synchronize()
                try:
                    graph.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = fn(*s_args, **s_kwargs)
                    except BaseException:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                except Exception as exc:  # noqa: BLE001 - run it eagerly
                    failed = exc
                else:
                    failed = None
                    got, want = (_pytree.tree_leaves(t) for t in (out, eager))
                    filled = len(got) == len(want) and all(
                        _fill(o, e) for o, e in zip(got, want)
                        if torch.is_tensor(o))
        finally:
            _local.depth -= 1
            cur.wait_stream(side)
        trace.count("graphs.eager")  # the eager run
        if failed is not None:
            self.stages[slot] = _Graph(sig)
            trace.count("graphs.fallbacks")
            trace.count("graphs.eager")
            warnings.warn(f"CUDA graph capture of {fn.__qualname__} failed, "
                          f"so it runs eagerly at this key: {failed}",
                          RuntimeWarning, stacklevel=4)
            return fn(*args, **kwargs)
        outs, out_spec = _pytree.tree_flatten(out)
        entry = _Graph(sig, graph, inputs, outs, out_spec, keep, self.token)
        self.stages[slot] = entry
        for b, _ in inputs:
            self._own(b)
        for o in outs:
            self._own(o)
        trace.count("graphs.captures")
        if filled:
            return _pytree.tree_unflatten(list(outs), out_spec)
        # an output no copy can be written into: the capture's replay
        return entry.replay([b for b, _ in inputs])


class _Batches:
    """The batch keys kept, oldest first; at most `size`."""

    def __init__(self, size: int):
        self.size = size
        self.items: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, make):
        item = self.items.get(key)
        if item is None:
            item = self.items[key] = make()
            while len(self.items) > self.size:
                _, old = self.items.popitem(last=False)
                old.close()
        self.items.move_to_end(key)
        return item

    def clear(self) -> None:
        while self.items:
            self.items.popitem(last=False)[1].close()


_batches = _Batches(MAX_BATCHES)


class _Eager:
    """A batch that captures nothing: stages run as they are, and on a
    device where batches engage each stage call counts as eager."""

    def __init__(self, count: bool):
        self.count = count

    def inputs(self, tree):
        return tree

    def outputs(self, tree):
        return tree

    def call(self, fn, args, kwargs):
        if self.count:
            trace.count("graphs.eager")
        return fn(*args, **kwargs)


@contextlib.contextmanager
def batch(device, key_args, params=()):
    """The graphs of one batch on `device`, keyed by `key_args` (the
    batch's arguments) and by the identity of `params` (the parameter
    sets its stages read, which the key keeps alive and the graphs read
    in place): a `Batch`, or where graphs cannot engage a stand-in that
    runs every stage eagerly.  Stage calls inside the block go through
    it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    b = None
    reason = eager_reason((), dev)
    if reason is None:
        keep: list = list(params)
        key = (dev, signature(key_args, keep), tuple(map(id, params)))
        with _lock:
            b = _batches.get(key, lambda: Batch(dev, keep, params))
            if b.busy:  # another thread runs this key: run eagerly
                b = None
            else:
                b.busy = True
    chosen = b if b is not None else _Eager(reason != "device")
    prev = getattr(_local, "batch", None)
    _local.batch = chosen
    if b is not None:
        b.index = 0
    try:
        yield chosen
    finally:
        _local.batch = prev
        if b is not None:
            b.busy = False


def graphed(fn):
    """Capture and replay `fn` as one stage of the open batch (module
    note); outside a batch, or inside another stage's capture, it runs
    as it is."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        b = getattr(_local, "batch", None)
        if b is None or getattr(_local, "depth", 0):
            return fn(*args, **kwargs)
        return b.call(fn, args, kwargs)
    return wrapped


def clear() -> None:
    """Free every kept batch key's graphs and pool."""
    with _lock:
        _batches.clear()
