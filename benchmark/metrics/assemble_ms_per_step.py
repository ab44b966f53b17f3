"""Assembly: ms per batched step in the span around `PTR._assemble`, over
the window's steps outside the device trace."""


def read(rec):
    steps = [s for s in rec["steps"] if not s["profiled"] and s["spans"]]
    if not steps:
        return None
    return 1e3 * sum(s["spans"].get("_assemble", 0.0)
                     for s in steps) / len(steps)
