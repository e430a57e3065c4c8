"""The device's idle share over the profiled steps, in %: 1 - busy / the
traced window, busy the union of every kernel and copy on the device."""


def read(record, arg=None):
    prof = record["profiled"]
    if prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
