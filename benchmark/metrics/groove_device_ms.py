"""Device ms per step under the `_groove` range (pipeline/landmarks.py:
find_peaks, the forest, the KDE)."""

from benchmark.metrics._ranges import per_step_ms


def read(record, arg=None):
    return per_step_ms(record, "_groove", "device_s")
