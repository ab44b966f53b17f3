"""SCP loop: iterations a scenario took, over the scenarios that stopped in
the window (SOLVED, FAILED or at the cap)."""


def read(rec):
    its = rec["stop_iters"]
    return sum(its) / len(its) if its else None
