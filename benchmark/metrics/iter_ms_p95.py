"""iter_ms_p95: in an LM worker, the 95th percentile of the window's
iterations; an iteration is the time between the ends of two consecutive
steps, as the device's events stamp them, so a sync or a host stall
between two steps falls inside one."""

from benchmark.trace import percentile


def read(rec):
    if rec["driver"] != "lm_ps":
        return None
    return percentile(rec["iter_ms"], 95)
