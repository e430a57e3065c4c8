"""The port's recorder (shoulder_tpu_torch/utils/trace.py): spans on the
profiler's clock, tied across threads, and the spans the program opens.

Every span and counter PERF.md lists is opened here, at tiny_config on
the CPU, so renaming one fails a test instead of silencing a metric.
"""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from shoulder_tpu_torch import bone, cohort
from shoulder_tpu_torch import config as config_mod
from shoulder_tpu_torch.config import tiny_config
from shoulder_tpu_torch.io import ingest, stl
from shoulder_tpu_torch.io.testdata import synthetic_humerus
from shoulder_tpu_torch.models import forest
from shoulder_tpu_torch.pipeline import batch as B
from shoulder_tpu_torch.pipeline import ct, graphs
from shoulder_tpu_torch.utils import trace

CFG = tiny_config()
# every span of one landmarks_batch call of a full bone, once each
STAGE_SPANS = (
    "landmarks.batch", "landmarks.sorted_geom", "landmarks.full_stack",
    "landmarks.surgical_neck", "landmarks.proximal_stack", "landmarks.canal",
    "landmarks.groove", "groove.peaks", "groove.forest", "groove.kde",
    "groove.argmin", "landmarks.anatomic_neck", "anp.image_points",
    "anp.segment", "anp.from_mask", "landmarks.transepicondylar",
    "landmarks.metrics",
)
SPHERE_SPANS = ("sphere_segment.score", "sphere_segment.fit",
                "sphere_segment.sigma", "sphere_segment.rim")
INGEST_SPANS = ("ingest.read_weld", "ingest.spec", "ingest.obb",
                "ingest.head", "ingest.presort")
# pipeline/graphs.py's always-on counters (benchmark/metrics/
# graph_hit_share.py reads the replays and the eager calls)
GRAPH_COUNTERS = ("graphs.captures", "graphs.replays", "graphs.eager",
                  "graphs.fallbacks")
# io/ingest.py's always-on counter: bones the size rule padded past the
# first of config.PADDINGS
INGEST_COUNTERS = ("ingest.dense",)


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    out = []
    for i, side in enumerate(("left", "right")):
        v, f = synthetic_humerus(side=side, n_rings=40, n_theta=32,
                                 rng_transform=np.random.default_rng(30 + i))
        out.append(d / f"bone{i}.stl")
        stl.write_stl(out[-1], v, f)
    return out


def _names(spans):
    names: dict = {}
    for s in spans:
        names[s.name] = names.get(s.name, 0) + 1
    return names


def test_off_records_nothing_and_shares_one_noop():
    """Off, span gives one shared context, which records nothing and
    gives no id; the decorator form calls straight through."""
    a, b = trace.span("a"), trace.span("b", request=3, cause=4)
    assert a is b
    with a as span_id:
        assert span_id is None
    assert trace.spanned("c")(lambda x: x + 1)(1) == 2
    assert trace.new_request() is None
    assert trace.spans() == []


def test_nested_spans_share_parent_and_request():
    with trace.recording():
        with trace.span("outer") as outer:
            with trace.span("inner") as inner:
                pass
            trace.spanned("deco")(lambda: None)()
        with trace.span("next"):
            pass
    by = {s.name: s for s in trace.spans()}
    assert [s.name for s in trace.spans()] == ["inner", "deco", "outer",
                                               "next"]
    assert by["outer"].id == outer and by["inner"].id == inner
    assert by["outer"].parent is None
    assert by["inner"].parent == outer and by["deco"].parent == outer
    assert by["inner"].request == by["deco"].request == by["outer"].request
    assert by["next"].request != by["outer"].request
    assert by["outer"].start_ns <= by["inner"].start_ns
    assert by["inner"].end_ns <= by["outer"].end_ns
    assert by["outer"].thread == threading.get_native_id()
    assert trace.span("after") is trace.span("off")


def test_worker_span_carries_request_and_cause():
    """A span in a worker thread, given the request of the span that handed
    it the work, and the waiter's span naming it as its cause."""
    def work(request):
        with trace.span("work", request=request) as span_id:
            with trace.span("step"):
                time.sleep(0.002)
            return span_id

    with trace.recording():
        with ThreadPoolExecutor(max_workers=1) as ex:
            with trace.span("hand"):
                rid = trace.new_request()
                fut = ex.submit(work, rid)
            with trace.span("wait", request=rid):
                trace.caused_by(fut.result())
    by = {s.name: s for s in trace.spans()}
    assert by["work"].thread != by["wait"].thread
    assert by["work"].parent is None and by["step"].parent == by["work"].id
    assert by["work"].request == by["step"].request == rid
    assert by["wait"].request == rid and by["wait"].cause == by["work"].id
    assert by["hand"].request != rid


def test_pool_tasks_open_spans_under_a_parent_of_another_thread():
    """Tasks on a pool, handed an id taken before its span opens, open
    their spans under it on their own threads, in its request; the span
    then opens with that id.  Off, nothing is taken or recorded."""
    def task(parent, request):
        with trace.under(parent, request):
            with trace.span("task"):
                with trace.span("step"):
                    pass
        with trace.span("after"):
            pass

    with trace.recording():
        rid = trace.new_request()
        pid = trace.new_span_id()
        with ThreadPoolExecutor(max_workers=3) as ex:
            futures = [ex.submit(task, pid, rid) for _ in range(6)]
            with trace.span("parent", request=rid, span_id=pid) as got:
                for f in futures:
                    f.result()
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    assert got == pid and by_id[pid].name == "parent"
    assert by_id[pid].parent is None and by_id[pid].request == rid
    tasks = [s for s in spans if s.name == "task"]
    assert len(tasks) == 6 and len(by_id) == len(spans)
    for s in tasks:
        assert s.parent == pid and s.request == rid
        assert s.thread != by_id[pid].thread
    for s in spans:
        if s.name == "step":
            assert by_id[s.parent].name == "task" and s.request == rid
        elif s.name == "after":
            assert s.parent is None and s.request != rid
    trace.reset()
    assert trace.new_span_id() is None
    with trace.under(None, None):
        with trace.span("off"):
            pass
    assert trace.spans() == []


def test_threads_lose_no_count_and_share_no_id():
    """More threads than cores, switching often: every count lands, every
    span gets its own id and its own thread's parent."""
    n_threads, n = 4 * (threading.active_count() + 8), 300

    def work():
        for _ in range(n):
            with trace.span("outer"):
                with trace.span("inner"):
                    trace.count("stress")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert trace.counter("stress") == n_threads * n
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans) == 2 * n_threads * n
    for s in spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer"
            assert by_id[s.parent].thread == s.thread


def test_span_on_the_profilers_clock():
    """A span and a profiler range opened back to back start within 1 ms of
    each other on the trace's clock (trace_start_ns + time_range.start)."""
    with trace.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(5):
                with trace.span(f"s{i}"):
                    with record_function(f"r{i}"):
                        torch.ones(8).sum()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e for e in prof.events() if e.name.startswith("r")}
    for s in trace.spans():
        r = ranges["r" + s.name[1:]]
        start = t0 + 1000 * r.time_range.start
        assert abs(start - s.start_ns) < 1e6, (s.name, start - s.start_ns)
    # no span left a range in the profile
    assert not any(e.name.startswith("s") and e.name[1:].isdigit()
                   for e in prof.events())


def test_landmarks_batch_opens_every_stage_span_once(paths):
    specs = [ingest.load_bone(p, config=CFG) for p in paths]
    bones = B.stack_bones(specs, "cpu")
    rf = forest.load_params("cpu")
    with trace.recording():
        lm = B.landmarks_to_numpy(B.compute_landmarks_batch(bones, rf,
                                                            cfg=CFG))
    names = _names(trace.spans())
    for name in STAGE_SPANS + ("batch.readback",):
        assert names.get(name) == 1, (name, names.get(name))
    for name in SPHERE_SPANS:
        assert names.get(name, 0) >= 1, name
    root = [s for s in trace.spans() if s.name == "landmarks.batch"][0]
    assert all(s.request == root.request for s in trace.spans()
               if s.name in STAGE_SPANS)
    assert lm.neck_z.shape == (2,)


def test_cohort_ties_each_wait_to_its_prefetch(paths):
    """process_cohort: per chunk one prefetch in the worker holding the
    ingest spans of its bones, and one wait on the main thread caused by
    it; counters count the bones and the wait's time, recording or
    not."""
    cohort.process_cohort(paths, config=CFG, batch_size=1, device="cpu")
    assert trace.spans() == []
    assert trace.counter("cohort.bones_ingested") == 2
    assert trace.counter("cohort.wait_ns") > 0
    trace.reset()
    with trace.recording():
        res = cohort.process_cohort(paths, config=CFG, batch_size=1,
                                    device="cpu")
    assert len(res) == 2
    spans = trace.spans()
    names = _names(spans)
    for name in ("cohort.prefetch", "cohort.wait", "cohort.batch",
                 "cohort.summary", "landmarks.batch") + INGEST_SPANS:
        assert names.get(name) == 2, (name, names.get(name))
    by_id = {s.id: s for s in spans}
    main = threading.get_native_id()
    for w in (s for s in spans if s.name == "cohort.wait"):
        pre = by_id[w.cause]
        assert pre.name == "cohort.prefetch" and pre.request == w.request
        assert w.thread == main and pre.thread != main
    for s in spans:
        if s.name.startswith("ingest."):
            top = s
            while top.parent is not None:
                top = by_id[top.parent]
            assert top.name == "cohort.prefetch"
    assert trace.counter("cohort.bones_ingested") == 2
    waited = sum(s.end_ns - s.start_ns for s in spans
                 if s.name == "cohort.wait")
    assert 0 < trace.counter("cohort.wait_ns") <= waited


MAIN, WORKER = 1, 2
# a batch with a stage on the main thread, a prefetch with an ingest on a
# worker, and a wait on the main thread caused by the prefetch
TIMELINE_SPANS = [
    trace.Span("batch", 1, None, 1, MAIN, 0, 100, None),
    trace.Span("stage", 2, 1, 1, MAIN, 20, 60, None),
    trace.Span("prefetch", 3, None, 2, WORKER, 90, 300, None),
    trace.Span("ingest.obb", 4, 3, 2, WORKER, 150, 250, None),
    trace.Span("wait", 5, None, 2, MAIN, 120, 280, 3),
]


def test_timeline_names_the_innermost_span_and_follows_a_cause():
    pieces = trace.timeline(TIMELINE_SPANS, MAIN, 0, 400)
    assert pieces == [
        (0, 20, "batch"), (20, 60, "stage"), (60, 100, "batch"),
        (120, 150, "wait <- prefetch"),
        (150, 250, "wait <- prefetch/ingest.obb"),
        (250, 280, "wait <- prefetch")]


def test_idle_gaps_split_over_spans_and_outside():
    pieces = trace.timeline(TIMELINE_SPANS, MAIN, 0, 400)
    named = trace.name_gaps([(10, 30), (100, 200), (290, 300)], pieces)
    want = {"batch": 10e-9, "stage": 10e-9, trace.OUTSIDE: 30e-9,
            "wait <- prefetch": 30e-9, "wait <- prefetch/ingest.obb": 50e-9}
    assert named.keys() == want.keys()
    assert all(abs(named[k] - want[k]) < 1e-15 for k in want)


def test_facade_spans(paths):
    """Humerus(validate=True): one humerus.init holding the load (the
    ingest), the validation and the landmarks; each csys one span."""
    with trace.recording():
        h = bone.Humerus(paths[0], config=CFG, validate=True, device="cpu")
        h.retroversion()
        h.apply_csys_canal_transepiconylar()
    spans = trace.spans()
    names = _names(spans)
    for name in ("humerus.init", "humerus.load", "humerus.validate",
                 "humerus.landmarks", "humerus.csys", "landmarks.batch",
                 "batch.readback") + INGEST_SPANS:
        assert names.get(name) == 1, (name, names.get(name))
    by = {s.name: s for s in spans}
    assert by["humerus.load"].parent == by["humerus.init"].id
    assert by["humerus.validate"].parent == by["humerus.init"].id
    assert by["humerus.landmarks"].parent == by["humerus.validate"].id
    assert by["humerus.csys"].parent is None


def test_ct_path_spans():
    """A volume through segment_volume (the 3D UNet) and volume_to_spec:
    one span each for the copies up and down, the UNet, the surface, the
    weld and the ingest."""
    vol, origin, spacing = ct.synth_ct_volume(
        shape=(107, 48, 48), spacing=(3.0, 3.0, 3.0), seed=1, noise_hu=15.0)
    cfg = tiny_config(max_faces=32768, max_verts=16384)
    with trace.recording():
        ct.segment_volume(vol[:16, :16, :16], "unet", device="cpu")
        spec = ct.volume_to_spec(vol, origin, spacing, 300.0, config=cfg,
                                 device="cpu")
    names = _names(trace.spans())
    assert names.pop("ct.upload") == 1
    for name in ("ct.unet3d", "ct.marching_tets", "ct.download", "ct.weld",
                 "ingest.spec"):
        assert names.get(name) == 1, (name, names.get(name))
    assert spec.n_faces > 0


def test_chrome_events():
    with trace.recording():
        with trace.span("a"):
            pass
    s = trace.spans()[0]
    (ev,) = trace.chrome_events(base_ns=s.start_ns - 5000)
    assert ev["ph"] == "X" and ev["name"] == "a" and ev["ts"] == 5.0
    assert ev["dur"] == (s.end_ns - s.start_ns) / 1e3
    assert ev["args"]["id"] == s.id and ev["tid"] == s.thread


def test_graph_counters_are_named_and_count_nothing_on_the_cpu(paths):
    """The CUDA-graph counters carry the names the benchmark reads; a
    batch on the CPU runs eagerly and counts none of them."""
    assert graphs.COUNTERS == GRAPH_COUNTERS
    spec = ingest.load_bone(paths[0], config=CFG)
    B.compute_landmarks_batch(B.stack_bones([spec], "cpu"),
                              forest.load_params("cpu"), cfg=CFG)
    assert all(trace.counter(name) == 0 for name in GRAPH_COUNTERS)


def test_ingest_counts_the_bones_padded_past_the_first_step(monkeypatch,
                                                            paths):
    """A bone that the first padding cannot hold, ingested without a
    config, counts once in ingest.dense; one with a config, never."""
    small = tiny_config(max_faces=2048, max_verts=1024)
    monkeypatch.setattr(config_mod, "PADDINGS", (small, CFG))
    (name,) = INGEST_COUNTERS
    assert ingest.load_bone(paths[0]).config is CFG
    assert trace.counter(name) == 1
    ingest.load_bone(paths[0], config=CFG)
    assert trace.counter(name) == 1
