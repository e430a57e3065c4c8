"""All answers completed over the whole window, per second."""

from benchmark.end_to_end._window import rate


def value(ctx) -> float:
    return rate(ctx)
