"""mfu.lm: the LM step's share of the card's dense bf16 peak, in percent:
the model FLOPs of one step (``costs.lm_step_flops``) over the mean device
time of the window's steps (their CUDA events)."""

import statistics

from benchmark.reference import costs


def read(rec):
    peak = costs.peaks(rec["device_kind"])
    if rec["driver"] != "lm_ps" or peak is None or not rec["step_ms"]:
        return None
    step_s = statistics.fmean(rec["step_ms"]) / 1e3
    return 100.0 * rec["step_flops"] / step_s / peak["bf16"]
