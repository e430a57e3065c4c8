"""Host ms per ingested bone that the cohort's main thread spends waiting
for its prefetch worker, over every `process_cohort` pass the run made
(the warm-up, the window's, the profiled one, the two watched for
synchronizing calls): the port's always-on counters `cohort.wait_ns` and
`cohort.bones_ingested` (cohort.py, shoulder_tpu_torch/utils/trace.py),
read from the process after the run.  None where the program keeps no
such counters."""


def read(record, arg=None):
    try:
        from shoulder_tpu_torch.utils import trace
    except ImportError:
        return None
    bones = trace.counter("cohort.bones_ingested")
    wait_ns = trace.counter("cohort.wait_ns")
    if not bones or not wait_ns:
        return None
    return wait_ns / 1e6 / bones
