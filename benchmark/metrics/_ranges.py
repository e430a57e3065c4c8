"""Host and device ms per step under one profiler range."""


def per_step_ms(record, name, which):
    prof = record["profiled"]
    r = prof["ranges"].get(name)
    if r is None or r[which] <= 0:
        return None
    return 1e3 * r[which] / prof["steps"]
