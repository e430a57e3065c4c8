"""Host ms per CT volume of the weld and ingest (io/native.py weld_soup,
io/ingest.py spec_from_arrays) over the window's unprofiled steps, by the
host clock."""

from benchmark.harness.ingest_split import ms_per


def read(record, arg=None):
    return ms_per(record["ingest"], ("weld_adjacency", "spec"))
