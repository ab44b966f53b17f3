"""IPM: ms per batched IPM loop in the span around `PTR._solve_sub`
(`ipm.solve_batched` with its KKT), over the window's steps outside the
device trace; a step's loops are its largest `ipm_iters` + 1."""


def read(rec):
    steps = [s for s in rec["steps"] if not s["profiled"] and s["spans"]]
    loops = sum(s.get("ipm_loops", 0) for s in steps)
    if not loops:
        return None
    return 1e3 * sum(s["spans"].get("_solve_sub", 0.0)
                     for s in steps) / loops
