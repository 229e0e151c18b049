"""sync_ms: the mean host time of the window's PS syncs (the table's Add
of the delta and Get, and the merged weights loaded into the model),
ended by a device synchronize."""

import statistics


def read(rec):
    if not rec.get("sync_ms"):
        return None
    return statistics.fmean(rec["sync_ms"])
