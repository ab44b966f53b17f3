"""Device: the share of the traced steps' wall in which no operation ran on
the card (1 - the union of the profiler's device intervals / the steps'
wall), %."""


def read(rec):
    prof = rec["profile"]
    if not prof or prof["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
