"""End to end: scenario SCP iterations done in the window (the active
scenarios of every batched iteration, summed) over the window's seconds."""


def read(rec):
    return rec["attempted"] / rec["window_s"]
