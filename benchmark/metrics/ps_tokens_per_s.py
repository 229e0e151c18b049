"""ps_tokens_per_s: an LM worker that syncs through the parameter server:
the tokens of every step completed in the window, over the window's wall
time, its whole sync periods included."""


def read(rec):
    if rec["driver"] != "lm_ps" or not rec["sync_every"]:
        return None
    return rec["tokens"] / rec["window_s"]
