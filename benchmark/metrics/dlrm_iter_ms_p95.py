"""dlrm_iter_ms_p95: in a DLRM trainer, the 95th percentile of the
window's iterations; an iteration is the time between the ends of two
consecutive steps, as the device's events stamp them, so a host stall
between two steps falls inside one."""

from benchmark.trace import percentile


def read(rec):
    if rec["driver"] != "dlrm":
        return None
    return percentile(rec["iter_ms"], 95)
