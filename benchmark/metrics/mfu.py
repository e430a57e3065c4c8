"""The whole step's share of the card's peak, in %: the work model's
least time for every counted piece of a step (benchmark/work; work it
does not count adds nothing, so this is a lower bound) over the measured
time per step of the window's unprofiled steps."""


def read(record, arg=None):
    work = record.get("work_s")
    if not work:
        return None
    step_s = record["window_s"] / len(record["steps"])
    return 100.0 * sum(work.values()) / step_s
