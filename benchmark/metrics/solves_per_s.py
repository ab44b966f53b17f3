"""End to end: scenarios solved per second, the window's scenario SCP
iterations over its seconds, divided by the mean iterations of the
scenarios that stopped in the window (SOLVED, FAILED or at the traffic's
cap). Counting whole batches instead would jump by a batch's share of the
window as a step's time crosses the window's end."""


def read(rec):
    its = rec["stop_iters"]
    if not its:
        return None
    return rec["attempted"] / rec["window_s"] / (sum(its) / len(its))
