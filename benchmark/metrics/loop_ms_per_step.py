"""SCP loop: host and device time of a step outside the three spanned
calls (discretize, assemble, IPM), ms per batched step, over the window's
steps outside the device trace."""


def read(rec):
    steps = [s for s in rec["steps"] if not s["profiled"] and s["spans"]]
    if not steps:
        return None
    return 1e3 * sum(s["wall_s"] - sum(s["spans"].values())
                     for s in steps) / len(steps)
