"""Kernel launches per step: the profiler's launch API calls over the
profiled steps plus the port's own launches (its wrappers' counters),
per step (utils/bench.py's count)."""


def read(record, arg=None):
    return record.get("launches")
