"""Share of the cohort's ingested bones whose ingest started while
another bone of the same `process_cohort` pass was still being ingested,
over every pass the run made (the warm-up, the window's, the profiled
one, the two watched for synchronizing calls): the port's always-on
counters `cohort.ingest_overlap` / `cohort.bones_ingested` (cohort.py,
shoulder_tpu_torch/utils/trace.py), read from the process after the
run.  None where the program keeps no such counter."""


def read(record, arg=None):
    try:
        from shoulder_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    bones = counts.get("cohort.bones_ingested", 0)
    if "cohort.ingest_overlap" not in counts or not bones:
        return None
    return counts["cohort.ingest_overlap"] / bones
