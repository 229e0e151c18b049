"""dlrm_examples_per_s: the examples of every step completed in the
window, over the window's wall time."""


def read(rec):
    if "examples" not in rec:
        return None
    return rec["examples"] / rec["window_s"]
