"""lm_step_ms: the mean device time of the window's LM steps (forward,
backward, SGD), between CUDA events recorded around each step."""

import statistics


def read(rec):
    if rec["driver"] != "lm_ps" or not rec["step_ms"]:
        return None
    return statistics.fmean(rec["step_ms"])
