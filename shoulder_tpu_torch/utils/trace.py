"""The port's tracing: spans on the profiler's clock, and counters.

A span is a named stretch of host time on one thread.  While recording
is on (`recording()`), each closed span is kept in memory as a `Span`:
its name, its id, the id of the innermost span open on the same thread
when it opened (its parent), a request id, the OS thread id, its start
and end in nanoseconds, and an optional `cause`, the id of a span on
another thread that it waited for.  A span with no parent opens a new
request; its children share that request.  Work handed to another
thread is tied back by hand: the worker's span is given the request of
the span that handed it the work (`request=`), and the span that waits
for it names the worker's span as its cause (`caused_by`).  Work split
over a pool names its parent on another thread: the parent's id is
taken before it opens (`new_span_id`, then `span(..., span_id=)`), and each
task opens its spans `under` that id and request.

Timestamps are `time.time_ns()`, the clock of torch.profiler's events
(`prof.profiler.kineto_results.trace_start_ns()` plus an event's
`time_range.start` in microseconds), so spans lie against the device
intervals of a profile taken at the same time without any shared
handle.  Spans open no profiler range: the profiler would put a copy of
each range on the card's timeline, where a trace reader takes it for
device work.

Recording is one process-wide switch, seen by every thread (the
profiler's own state is per thread).  Off, `span` costs one global check
and returns one shared no-op context; `spanned` adds a function call.

Counters (`count`, `counter`, `counters`) are always on: one locked add
to one in-memory table.  Nothing here writes a file; `chrome_events`
gives the spans as Chrome trace events for a trace file written
elsewhere (tools/profile_torch_batch.py --trace).  `timeline` and
`name_gaps` name a device's idle time by the span the host was in.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None
    request: int
    thread: int
    start_ns: int
    end_ns: int
    cause: int | None


class _Thread(threading.local):
    """This thread's open spans, innermost last, and its OS id."""

    def __init__(self):
        self.stack = []
        self.id = threading.get_native_id()


_on = False
_spans: list[tuple] = []  # Span fields, as plain tuples
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = _Thread()
_counters: dict[str, int] = {}
_count_lock = threading.Lock()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Parent:
    """A span of another thread standing at the bottom of this thread's
    stack, so that spans opened over it are its children."""

    __slots__ = ("id", "request", "cause")

    def __init__(self, span_id, request):
        self.id, self.request, self.cause = span_id, request, None

    def __enter__(self):
        _local.stack.append(self)

    def __exit__(self, *exc):
        _local.stack.pop()
        return False


class _Open:
    __slots__ = ("name", "request", "cause", "id", "parent", "start")

    def __init__(self, name, request, cause, span_id=None):
        self.name, self.request, self.cause = name, request, cause
        self.id = span_id

    def __enter__(self):
        stack = _local.stack
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.request is None:
                self.request = top.request
        else:
            self.parent = None
            if self.request is None:
                self.request = next(_requests)
        if self.id is None:
            self.id = next(_ids)
        stack.append(self)
        self.start = time.time_ns()
        return self.id

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        _spans.append((self.name, self.id, self.parent, self.request,
                       _local.id, self.start, end, self.cause))
        return False


def span(name: str, request: int | None = None, cause: int | None = None,
         span_id: int | None = None):
    """A context manager that records the span `name` while recording is
    on; entering it gives the span's id (None when off).  `request` and
    `cause` tie a span on a worker thread to the span that handed it the
    work; `span_id`, from `new_span_id`, is an id already handed to tasks
    on other threads as their parent."""
    if not _on:
        return _NOOP
    return _Open(name, request, cause, span_id)


def under(span_id: int | None, request: int | None):
    """A context manager within which spans opened on this thread are
    children of the span `span_id` of another thread (from `new_span_id`)
    and belong to its `request`; no change when `span_id` is None."""
    if span_id is None:
        return _NOOP
    return _Parent(span_id, request)


def spanned(name: str):
    """The decorator form of `span`: each call of the function is one span
    `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name, None, None):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def caused_by(span_id: int | None) -> None:
    """Name `span_id` as the cause of this thread's innermost open span
    (what it waited for)."""
    if _on and span_id is not None:
        stack = _local.stack
        if stack:
            stack[-1].cause = span_id


def new_span_id() -> int | None:
    """A fresh span id, taken before its span opens (`span(..., span_id=)`),
    to hand to tasks on other threads that open their spans `under` it
    (None when recording is off)."""
    return next(_ids) if _on else None


def new_request() -> int | None:
    """A fresh request id to hand to the spans of one piece of work that
    crosses threads (None when recording is off)."""
    return next(_requests) if _on else None


@contextlib.contextmanager
def recording():
    """Record spans within the block, from every thread."""
    global _on
    was = _on
    _on = True
    try:
        yield
    finally:
        _on = was


def spans() -> list[Span]:
    """Every span closed while recording, in the order they closed."""
    return [Span._make(s) for s in _spans]


def count(name: str, n: int = 1) -> None:
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters() -> dict[str, int]:
    with _count_lock:
        return dict(_counters)


def reset(names=None) -> None:
    """Drop the recorded spans and set every counter, or those in
    `names`, to 0."""
    with _count_lock:
        if names is None:
            _spans.clear()
            _counters.clear()
        else:
            for name in names:
                _counters.pop(name, None)


def chrome_events(base_ns: int = 0) -> list[dict]:
    """The recorded spans as Chrome trace events ("X"), at microseconds
    after `base_ns` (a torch.profiler trace's `baseTimeNanoseconds`)."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
             "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "request": s.request,
                      "cause": s.cause}}
            for s in spans()]


OUTSIDE = "outside program spans"


def _children(spans) -> dict:
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.start_ns)
    return kids


def _segments(span, a, b, kids):
    """[(t0, t1, innermost span)] over [a, b] inside `span`."""
    a, b = max(a, span.start_ns), min(b, span.end_ns)
    out = []
    t = a
    for c in kids.get(span.id, ()):
        if c.end_ns <= t or c.start_ns >= b:
            continue
        if c.start_ns > t:
            out.append((t, c.start_ns, span))
        out.extend(_segments(c, t, b, kids))
        t = max(t, min(c.end_ns, b))
    if t < b:
        out.append((t, b, span))
    return out


def timeline(spans, thread: int, a: int, b: int) -> list:
    """One thread's time in [a, b] (ns) as sorted [(t0, t1, name)], each
    piece named by its innermost span; a span with a cause names the
    cause's innermost span where the two overlap
    (`cohort.wait <- cohort.prefetch/ingest.obb`)."""
    kids = _children(spans)
    by_id = {s.id: s for s in spans}
    roots = [s for s in kids.get(None, ()) if s.thread == thread
             and s.end_ns > a and s.start_ns < b]
    out = []
    for r in roots:
        for t0, t1, s in _segments(r, a, b, kids):
            cause = by_id.get(s.cause) if s.cause is not None else None
            if cause is None:
                out.append((t0, t1, s.name))
                continue
            t = t0
            for c0, c1, inner in _segments(cause, t0, t1, kids):
                if c0 > t:
                    out.append((t, c0, s.name))
                path = cause.name + ("" if inner is cause
                                     else "/" + inner.name)
                out.append((c0, c1, f"{s.name} <- {path}"))
                t = c1
            if t < t1:
                out.append((t, t1, s.name))
    return sorted(out)


def name_gaps(gaps, pieces) -> dict:
    """Seconds of each gap [(g0, g1)] (ns, sorted, disjoint: a device's
    idle time) under each named piece of `pieces` (a `timeline`); the
    rest under OUTSIDE."""
    out: dict = {}
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            p0, p1, name = pieces[k]
            ov = min(g1, p1) - max(g0, p0)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov / 1e9
                covered += ov
            k += 1
        if g1 - g0 > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - covered) / 1e9
    return out
