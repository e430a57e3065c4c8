"""A piece of work's share of its roofline, in %: the work model's least
time for the piece's calls in the profiled steps (benchmark/work, from
the reference's own run of the same inputs) over the device time of its
ranges and kernels in those steps.  Nothing where the trace or the work
model holds none of the piece."""

from benchmark.harness.trace import piece_device_s


def read(record, piece):
    least = record.get("work_prof_s", {}).get(piece)
    dev = piece_device_s(record, piece)
    if not least or not dev:
        return None
    return 100.0 * least / dev
