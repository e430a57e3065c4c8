"""Synchronizing calls of one step, under
torch.cuda.set_sync_debug_mode("warn") (the second of two watched
steps)."""


def read(record, arg=None):
    return record.get("syncs")
