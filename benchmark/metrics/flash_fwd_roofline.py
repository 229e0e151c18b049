"""flash_fwd_roofline: the flash forward kernel's (B1) least time at the
cell's [B, H, S, D] (the larger of its bytes over the memory rate and its
causal FLOPs over the bf16 rate, ``costs.flash_fwd``), times its calls,
over its device time in the trace, in percent."""

from benchmark.reference import costs


def read(rec):
    tr, peak = rec.get("trace"), costs.peaks(rec["device_kind"])
    if tr is None or peak is None or "attn_shape" not in rec:
        return None
    n, t = tr.time_of("flash_fwd_wgmma")
    if n == 0 or t <= 0:
        return None
    least = costs.least_time(*costs.flash_fwd(*rec["attn_shape"]), peak)
    return 100.0 * n * least / t
