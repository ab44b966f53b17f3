"""KKT: launches of the hand-written kernels (the LU and Cholesky-ladder
wrappers' counters) per batched IPM loop, over every step of the window."""


def read(rec):
    loops = sum(s.get("ipm_loops", 0) for s in rec["steps"])
    if not loops or rec["launches"] is None:
        return None
    return sum(rec["launches"].values()) / loops
