"""pipeline/graphs.py on the CPU: the keys, the cases in which a stage
runs eagerly (the CPU, the NaN trap's dispatch mode, a capture under way,
grad), the batch's own buffers, the parameter sets read in place, a
first call and a replay through a stand-in graph, a capture that fails,
and the eviction of the oldest batch key.  Capture and replay themselves
need a card: tests/test_torch_cuda.py holds replayed batches against
eager ones."""

import contextlib

import numpy as np
import pytest
import torch

from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.io import ingest, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.models import forest
from shoulder_tpu_torch.pipeline import batch as B
from shoulder_tpu_torch.pipeline import graphs
from shoulder_tpu_torch.pipeline import landmarks as L
from shoulder_tpu_torch.utils import nan_trap, trace

CFG = tiny_config()
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    graphs.clear()
    yield
    graphs.clear()
    trace.reset()


def _key(tree):
    return graphs.signature(tree, [])


class _Params:
    """An argument with no value of its own (not hashable): keyed by
    identity."""
    __hash__ = None


@pytest.mark.parametrize("case", ["shape", "stride", "dtype", "int", "float",
                                  "bool", "config", "structure", "identity"])
def test_keys_separate(case):
    x = torch.zeros(4, 3)
    cfg2 = tiny_config(max_faces=CFG.max_faces * 2)
    p1, p2 = _Params(), _Params()
    a, b = {
        "shape": ((x,), (torch.zeros(4, 4),)),
        "stride": ((x,), (torch.zeros(3, 4).t(),)),
        "dtype": ((x,), (x.double(),)),
        "int": ((x, 2), (x, 3)),
        "float": ((x, 0.5), (x, 0.25)),
        "bool": ((x, True), (x, False)),
        "config": ((x, CFG), (x, cfg2)),
        "structure": ((x, (x,)), (x, [x])),
        "identity": ((x, p1), (x, p2)),
    }[case]
    assert _key(a) != _key(b)


def test_keys_equal_for_the_same_shapes_and_values():
    """Tensor values are not part of a key: a later call with other data of
    the same shapes replays."""
    keep: list = []
    p = _Params()
    a = graphs.signature((torch.zeros(4, 3), 2, CFG, p, None), keep)
    b = graphs.signature((torch.ones(4, 3), 2, tiny_config(), p, None), [])
    assert a == b and keep == [p]
    bones = L.BoneTensors(*(torch.zeros(2, 3) for _ in range(10)))
    assert _key(bones) == _key(L.BoneTensors(*(torch.ones(2, 3)
                                               for _ in range(10))))
    assert _key(bones) != _key(tuple(bones))


@pytest.fixture(scope="module")
def bones(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    specs = []
    for i, side in enumerate(("left", "right")):
        v, f = synthetic_humerus(side=side, n_rings=40, n_theta=32,
                                 rng_transform=np.random.default_rng(50 + i))
        stl.write_stl(d / f"b{i}.stl", v, f)
        specs.append(ingest.load_bone(d / f"b{i}.stl", config=CFG))
    return B.stack_bones(specs, CPU)


def _equal(a, b):
    return all(torch.equal(x, y) or (x.is_floating_point()
                                     and torch.equal(torch.isnan(x),
                                                     torch.isnan(y))
                                     and torch.equal(x.nan_to_num(),
                                                     y.nan_to_num()))
               for x, y in zip(a, b))


def test_cpu_batch_runs_eagerly_and_counts_nothing(bones):
    """On the CPU no batch engages: landmarks_batch is its stages' eager
    run bit for bit, returns no buffer of the module's, counts nothing."""
    rf = forest.load_params(CPU)
    got = L.landmarks_batch(bones, rf, cfg=CFG)
    want = L._stages(bones, rf, False, CFG, 150, None, None)
    assert _equal(got, want)
    assert not any(trace.counter(c) for c in graphs.COUNTERS)
    assert not graphs._batches.items


class _NoGraph:
    def __init__(self, *a, **k):
        raise AssertionError("no capture may start")


def _engage_on_cpu(monkeypatch):
    """Let a batch engage on the CPU: every reason to run eagerly holds
    but the device's type."""
    monkeypatch.setattr(graphs, "eager_reason", graphs._unfit)


@pytest.fixture
def cpu_engages(monkeypatch):
    """Let a batch engage on the CPU, where any capture would fail
    loudly: only the eager cases below may run."""
    _engage_on_cpu(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)


def _stage(x, y, scale: float):
    return torch.sin(x) * scale + y.sum(dim=-1, keepdim=True)


_graphed_stage = graphs.graphed(_stage)


@pytest.mark.parametrize("case", ["nan_trap", "capture", "grad_tensor",
                                  "grad_module"])
def test_ineligible_stage_runs_eagerly(cpu_engages, monkeypatch, case):
    """Under the NaN trap's dispatch mode, during a capture, and with an
    argument that requires grad, a stage in an open batch runs eagerly,
    bit for bit its plain call, and counts as eager."""
    x = torch.linspace(-1.0, 1.0, 24).reshape(4, 6)
    y = torch.arange(24.0).reshape(4, 6)
    extra = ()
    ctx = contextlib.nullcontext()
    if case == "nan_trap":
        ctx = nan_trap.trap()
    elif case == "capture":
        monkeypatch.setattr(graphs, "_capturing", lambda device: True)
    elif case == "grad_tensor":
        x = x.clone().requires_grad_(True)
    else:
        extra = (torch.nn.Linear(2, 2),)
    want = _stage(x, y, 0.5)

    def run(x, y, scale, *module):
        return _stage(x, y, scale)

    staged = graphs.graphed(run)
    with ctx, graphs.batch(CPU, ("key",)):
        got = staged(x, y, 0.5, *extra)
    assert torch.equal(got, want)
    assert trace.counter("graphs.eager") == 1
    assert trace.counter("graphs.captures") == 0


def test_outside_a_batch_a_stage_counts_nothing(cpu_engages):
    x = torch.ones(3)
    assert torch.equal(_graphed_stage(x, x, 2.0), _stage(x, x, 2.0))
    assert not any(trace.counter(c) for c in graphs.COUNTERS)


def test_batch_inputs_are_its_own_buffers_and_outputs_are_fresh():
    """`inputs` copies a batch's tensors into the same buffers at every
    call; `outputs` clones what lives in them and leaves other tensors."""
    b = graphs.Batch(CPU, [])
    first = b.inputs((torch.ones(2, 3), 7, torch.zeros(4)))
    second = b.inputs((torch.full((2, 3), 5.0), 7, torch.arange(4.0)))
    assert first[0] is second[0] and first[2] is second[2]
    assert first[1] == 7 and torch.equal(second[0], torch.full((2, 3), 5.0))
    other = torch.ones(2)
    view = second[0][:, 1]
    out = b.outputs((second[0], view, other))
    assert out[2] is other
    for got, src in zip(out[:2], (second[0], view)):
        assert got is not src and torch.equal(got, src)
        assert (got.untyped_storage().data_ptr()
                != src.untyped_storage().data_ptr())
    # a tensor that is not dense is not staged
    t = torch.zeros(4, 4)[:, :2]
    assert b.inputs((t,))[0] is t


class _FailingGraph:
    def capture_begin(self, *a, **k):
        raise RuntimeError("capture refused")

    def capture_end(self):
        raise AssertionError("never begun")


class _Stream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


class _StandInGraph:
    """A graph whose capture runs its stage on the CPU and whose replay
    runs nothing, counted."""
    replays = 0

    def capture_begin(self, *a, **k):
        pass

    def capture_end(self):
        pass

    def replay(self):
        type(self).replays += 1


def _stand_in_card(monkeypatch, graph):
    """A batch on the CPU with `graph` for torch.cuda.CUDAGraph and no
    streams."""
    _engage_on_cpu(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_side", {})


def test_first_call_returns_its_eager_result_and_the_next_replays(
        monkeypatch):
    """The first call at a key returns its eager run's result, in the
    capture's output buffers, without a replay; the next call copies its
    arguments into the capture's input buffers, replays, and returns the
    same buffers."""
    _stand_in_card(monkeypatch, _StandInGraph)
    monkeypatch.setattr(_StandInGraph, "replays", 0)
    x, y = torch.ones(3, 2), torch.arange(6.0).reshape(3, 2)
    with graphs.batch(CPU, ("k",)) as b:
        first = _graphed_stage(x, y, 3.0)
    assert torch.equal(first, _stage(x, y, 3.0)) and b._owns(first)
    assert (trace.counter("graphs.eager"), trace.counter("graphs.captures"),
            trace.counter("graphs.replays"), _StandInGraph.replays) == (
                1, 1, 0, 0)
    with graphs.batch(CPU, ("k",)):
        again = _graphed_stage(y, x, 3.0)
    assert again is first
    assert trace.counter("graphs.replays") == 1 == _StandInGraph.replays
    (entry,) = b.stages.values()
    assert torch.equal(entry.inputs[0][0], y)
    assert torch.equal(entry.inputs[1][0], x)


def test_parameter_sets_are_keyed_by_identity_and_read_in_place(
        monkeypatch):
    """A parameter set's tensors are the capture's own inputs, read in
    place (no copy at a replay); another set of the same shapes is
    another batch key, kept alive by it."""
    _stand_in_card(monkeypatch, _StandInGraph)
    params = (torch.ones(3, 1),)
    x = torch.arange(6.0).reshape(3, 2)
    with graphs.batch(CPU, ("k",), params=(params,)) as b:
        _graphed_stage(x, params[0], 2.0)
    (entry,) = b.stages.values()
    assert entry.inputs[1][0] is params[0] and entry.inputs[1][1] is True
    assert entry.inputs[0][0] is not x and entry.inputs[0][1] is False
    other = (torch.ones(3, 1),)
    with graphs.batch(CPU, ("k",), params=(other,)) as b2:
        assert b2 is not b and any(p is other for p in b2.keep)
    with graphs.batch(CPU, ("k",), params=(params,)) as b3:
        assert b3 is b


@pytest.mark.parametrize("case", ["contiguous", "transposed", "expanded",
                                  "same", "strides_differ"])
def test_fill_copies_each_memory_location_once(case):
    """The eager result goes into the capture's output buffer: an
    expanded buffer at its first index along the expanded dimension; a
    buffer of other strides is refused (the call then replays)."""
    src = torch.arange(12.0).reshape(3, 4)
    dst = torch.zeros(3, 4)
    if case == "transposed":
        src, dst = src.t(), torch.zeros(3, 4).t()
    elif case == "expanded":
        src = torch.arange(4.0)[None].expand(3, 4)
        dst = torch.zeros(1, 4).expand(3, 4)
    elif case == "same":
        dst = src
    elif case == "strides_differ":
        dst = torch.zeros(4, 3).t()
    ok = graphs._fill(dst, src)
    assert ok == (case != "strides_differ")
    assert torch.equal(dst, src) == ok


def test_failed_capture_runs_eagerly_and_stays_eager(monkeypatch):
    """A capture that fails: the call runs eagerly (bit for bit), warns
    once, counts one fallback, and the key is not captured again."""
    _stand_in_card(monkeypatch, _FailingGraph)
    x, y = torch.ones(3, 2), torch.arange(6.0).reshape(3, 2)
    with pytest.warns(RuntimeWarning, match="capture refused"):
        with graphs.batch(CPU, ("k",)):
            got = _graphed_stage(x, y, 3.0)
    assert torch.equal(got, _stage(x, y, 3.0))
    assert trace.counter("graphs.fallbacks") == 1
    # the run before the capture and the eager run after it
    assert trace.counter("graphs.eager") == 2
    with graphs.batch(CPU, ("k",)):
        again = _graphed_stage(y, x, 3.0)
    assert torch.equal(again, _stage(y, x, 3.0))
    assert trace.counter("graphs.fallbacks") == 1
    assert trace.counter("graphs.eager") == 3
    assert trace.counter("graphs.captures") == 0


class _Item:
    def __init__(self, name, closed):
        self.name, self.closed = name, closed

    def close(self):
        self.closed.append(self.name)


def test_eviction_drops_the_oldest_key():
    closed: list = []
    cache = graphs._Batches(2)
    for name in ("a", "b"):
        cache.get(name, lambda name=name: _Item(name, closed))
    cache.get("a", lambda: _Item("a2", closed))    # a is the newest now
    cache.get("c", lambda: _Item("c", closed))
    assert closed == ["b"] and list(cache.items) == ["a", "c"]
    assert cache.get("a", lambda: None).name == "a"
    cache.get("d", lambda: _Item("d", closed))
    assert closed == ["b", "c"]
    cache.clear()
    assert sorted(closed) == ["a", "b", "c", "d"] and not cache.items


def test_a_batch_key_keeps_its_objects(cpu_engages):
    """Objects keyed by identity stay alive while their key is kept, so no
    other object can take their id."""
    p = _Params()
    with graphs.batch(CPU, (p,)) as b:
        assert isinstance(b, graphs.Batch)
        assert any(k is p for k in b.keep)
    (key,) = graphs._batches.items
    assert graphs._batches.items[key] is b
    with graphs.batch(CPU, (_Params(),)) as b2:
        assert b2 is not b


def test_a_busy_key_runs_eagerly(cpu_engages):
    """A key already open (another thread's batch) is not shared: the
    second opening runs its stages eagerly."""
    with graphs.batch(CPU, ("same",)) as outer:
        with graphs.batch(CPU, ("same",)) as inner:
            assert isinstance(outer, graphs.Batch)
            assert not isinstance(inner, graphs.Batch)
            x = torch.ones(2)
            _graphed_stage(x, x, 1.0)
    assert trace.counter("graphs.eager") == 1
    assert trace.counter("graphs.captures") == 0


@pytest.mark.parametrize("case", ["contiguous", "transposed", "column",
                                  "strided_rows", "expanded"])
def test_input_buffers_keep_the_argument_layout(case):
    """A stage's input buffer has its argument's shape and strides and
    holds a copy of it; an expanded view (elements sharing memory) gets
    none, so its stage runs eagerly."""
    base = torch.arange(40.0).reshape(8, 5)
    x = {"contiguous": base, "transposed": base.t(), "column": base[:, 3],
         "strided_rows": base[::2, 1:4],
         "expanded": base[:, :1].expand(8, 6)}[case]
    buf = graphs._buffer(x)
    if case == "expanded":
        assert buf is None
        return
    assert buf.shape == x.shape and buf.stride() == x.stride()
    assert torch.equal(buf, x)
    assert buf.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
