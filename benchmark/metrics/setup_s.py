"""setup_s: seconds from the process's start to the first timed step
(loading, building, weights and batches, the first steps, warm-up)."""


def read(rec):
    return rec["setup_s"]
