"""Host ms per step under the `_anp_from_mask` range (pipeline/
landmarks.py: the plane fits and rays of the anatomic neck)."""

from benchmark.metrics._ranges import per_step_ms


def read(record, arg=None):
    return per_step_ms(record, "_anp_from_mask", "host_s")
