"""The 95th percentile of every step's latency in the window, in ms: a
step is one request of the closed loop (a batch, or one bone through the
facade), timed from its start to its last answer."""

import numpy as np

from benchmark.end_to_end._window import step_ms


def value(ctx) -> float:
    return float(np.percentile(step_ms(ctx), 95))
