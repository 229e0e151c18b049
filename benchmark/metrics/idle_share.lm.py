"""idle_share.lm: in an LM worker that does not sync in the window, the
share of the traced window in which no kernel, copy or set runs on the
device, in percent."""


def read(rec):
    tr = rec.get("trace")
    if rec["driver"] != "lm_ps" or rec["sync_every"] or tr is None \
            or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
