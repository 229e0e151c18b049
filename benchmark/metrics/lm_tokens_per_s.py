"""lm_tokens_per_s: an LM worker that does not sync in the window: the
tokens of every step completed in the window, over the window's wall
time."""


def read(rec):
    if rec["driver"] != "lm_ps" or rec["sync_every"]:
        return None
    return rec["tokens"] / rec["window_s"]
