"""flash_bwd_roofline: the flash backward kernels' (B2, dQ; B3, dK and dV
with its delta pre-pass) summed least times at the cell's [B, H, S, D]
(``costs.flash_bwd_dq``, ``costs.flash_bwd_dkv``), over their summed
device time in the trace, in percent."""

from benchmark.reference import costs


def read(rec):
    tr, peak = rec.get("trace"), costs.peaks(rec["device_kind"])
    if tr is None or peak is None or "attn_shape" not in rec:
        return None
    n_dq, t_dq = tr.time_of("flash_bwd_dq_wgmma")
    _, t_dkv = tr.time_of("flash_bwd_dkv_wgmma", "flash_bwd_dkv_delta")
    n_main, _ = tr.time_of("flash_bwd_dkv_wgmma")
    if n_dq == 0 or n_main == 0:
        return None
    shape = rec["attn_shape"]
    least = (n_dq * costs.least_time(*costs.flash_bwd_dq(*shape), peak)
             + n_main * costs.least_time(*costs.flash_bwd_dkv(*shape), peak))
    return 100.0 * least / (t_dq + t_dkv)
