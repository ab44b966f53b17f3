"""The yardstick for the kernels' roofline shares, frozen with the benchmark.

The operations and bytes of each hand-written kernel are computed from its
launch shape alone (each input byte read once, each output byte written
once), and its least time on the card is the larger of operations over the
peak rate and bytes over the peak bandwidth. The formulas are those the
port's kernel table has used since its first slice; they live here so that a
change to the program cannot change what its kernels are measured against.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W power limit: 67 TFLOP/s in float32 outside the tensor cores and in
float64 on the FP64 tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = {"f32": 67e12, "f64": 67e12}
PEAK_BYTES = 3.35e12
ITEM_SIZE = {"f32": 4, "f64": 8}

# the wrappers' kernel names (the port's launch record) each share measures
KERNELS = {"lu_factor": ("lu_factor",), "lu_solve": ("lu_solve",),
           "cholesky": ("cholesky",),
           "tri_solve": ("solve_lower", "solve_lower_t")}


def factor_work(nb, s, isz):
    """Pivoted LU of nb s x s blocks: 2/3 s^3 + s^2/2 flops; the block read,
    the factor written, the pivot record (int32) written."""
    return nb * (2.0 / 3.0 * s ** 3 + 0.5 * s * s), nb * (2 * s * s * isz
                                                          + 4 * s)


def solve_work(nb, s, K, isz):
    """LU solve with K right-hand sides: 2 s^2 K flops; the factor and the
    pivot record read, the right-hand sides read and the solution written."""
    return nb * 2.0 * s * s * K, nb * (s * s * isz + 4 * s + 2 * s * K * isz)


def chol_work(nb, n, isz):
    """n^3/3 flops; the lower triangle read, the whole factor written."""
    return nb * n ** 3 / 3.0, nb * (n * (n + 1) // 2 + n * n) * isz


def trisolve_work(nb, n, K, isz):
    """n^2 K flops; the triangle read, the right-hand sides read and the
    solution written."""
    return nb * float(n) * n * K, nb * (n * (n + 1) // 2 + 2 * n * K) * isz


def work(kernel, nb, n, K, isz):
    """(flops, bytes) of one launch of a wrapper's kernel."""
    if kernel == "lu_factor":
        return factor_work(nb, n, isz)
    if kernel == "lu_solve":
        return solve_work(nb, n, K, isz)
    if kernel == "cholesky":
        return chol_work(nb, n, isz)
    if kernel in ("solve_lower", "solve_lower_t"):
        return trisolve_work(nb, n, K, isz)
    raise KeyError(kernel)


def bound_s(kernel, dt, nb, n, K):
    """(least seconds, "bytes" or "operations") of one launch, from the
    launch record's key (kernel, dtype suffix, nb, n, K)."""
    flops, nbytes = work(kernel, nb, n, K, ITEM_SIZE[dt])
    t_ops = flops / PEAK_FLOPS[dt]
    t_bytes = nbytes / PEAK_BYTES
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_total(shapes, share):
    """Least seconds of every launch in `shapes` ({(kernel, dt, nb, n, K):
    launches}) that belongs to the share `share` (a key of KERNELS)."""
    return sum(count * bound_s(kernel, dt, nb, n, K)[0]
               for (kernel, dt, nb, n, K), count in shapes.items()
               if kernel in KERNELS[share])
