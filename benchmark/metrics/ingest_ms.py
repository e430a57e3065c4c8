"""Host ms per ingested bone of the port's host ingest (io/ingest.py,
io/native.py, host/obb.py) over the window's unprofiled steps: the STL
read, weld and adjacency (`load_indexed`) and the rest of the ingest
(`spec_from_arrays`: OBB, head detection, presort), by the host clock."""

from benchmark.harness.ingest_split import ms_per


def read(record, arg=None):
    return ms_per(record["ingest"], ("read_weld_adjacency", "spec"))
