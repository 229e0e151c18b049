"""idle_share.ps: in an LM worker that syncs through the parameter
server, the share of the traced window (whole sync periods) in which no
kernel, copy or set runs on the device, in percent."""


def read(rec):
    tr = rec.get("trace")
    if rec["driver"] != "lm_ps" or not rec["sync_every"] or tr is None \
            or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
