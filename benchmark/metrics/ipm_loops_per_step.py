"""IPM: batched IPM loops a step (the step's largest `ipm_iters` + 1, from
the loop's traces), over every step of the window."""


def read(rec):
    steps = rec["steps"]
    if not steps:
        return None
    return sum(s.get("ipm_loops", 0) for s in steps) / len(steps)
