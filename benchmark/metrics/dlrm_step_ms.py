"""dlrm_step_ms: the mean device time of the window's DLRM steps, between
CUDA events recorded around each step."""

import statistics


def read(rec):
    if rec["driver"] != "dlrm" or not rec["step_ms"]:
        return None
    return statistics.fmean(rec["step_ms"])
