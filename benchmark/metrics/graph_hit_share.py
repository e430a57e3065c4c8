"""Share of the landmark stages' calls on the card that replayed a CUDA
graph, over every batch the run made (set-up, window, profiled stretch,
the steps watched for synchronizing calls): the port's always-on
counters `graphs.replays` / (`graphs.replays` + `graphs.eager`)
(shoulder_tpu_torch/pipeline/graphs.py, utils/trace.py), read from the
process after the run.  None where the program keeps no such counters
or made no stage call on the card."""


def read(record, arg=None):
    try:
        from shoulder_tpu_torch.utils import trace
    except ImportError:
        return None
    replays = trace.counter("graphs.replays")
    eager = trace.counter("graphs.eager")
    if replays + eager == 0:
        return None
    return replays / (replays + eager)
