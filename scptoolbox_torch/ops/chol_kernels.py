"""Batched dense Cholesky and triangular solves: the Hopper kernels and their
plain PyTorch versions.

`cholesky` / `solve_lower` / `solve_lower_t` replace the TPU kernels of
scptoolbox_tpu/ops/pallas_kernels.py (`_cholesky_kernel` :65,
`_fwd_solve_kernel` :129, `_bwd_solve_kernel` :154), and `cho_solve` is
their composition as in JAX (two launches). They carry the dense Schur KKT's
Cholesky ladder (ops/ipm.py `_SchurKKT`). Contract, per matrix:

* cholesky(H (..., n, n)) -> L: right-looking; step j scales column j (rows
  >= j) by 1/sqrt(d_j) and subtracts the outer product of its part below the
  diagonal from the trailing lower triangle. Only the lower triangle of H is
  read; L is zero above the diagonal. A non-SPD input is not reported: its
  first non-positive pivot turns the rest of the factor into NaN or inf, as
  in the Pallas kernel and `jnp.linalg.cholesky` (the IPM's best-iterate
  fallback and stall detector count on that).
* solve_lower(L, B) -> Y with L Y = B; solve_lower_t(L, B) -> X with
  L' X = B, reading L in place. B is (..., n, K) or the vector (..., n); its
  leading dimensions are L's.

On a CUDA tensor a wrapper launches its CUDA C++ kernel
(scptoolbox_torch/csrc/chol_kernels.cu, built with nvcc for sm_90a at first
use, see ops/cuda_lib.py) or raises; on a CPU tensor it runs the plain
version. The launcher picks the kernel's design from the batch: one thread
block per matrix when the batch fills the card (for `solve_lower` with its
panels of L staged in shared memory), and for a few matrices the factor
spread over a cooperative grid and both solves over thread block clusters
(the source's note says how). The kernels take contiguous operands: a transposed view (the
Schur KKT's A_E') is copied by `.contiguous()` first. The plain versions do
the kernels' operations in the same order, so on the card the two agree bit
for bit. Each wrapper counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from scptoolbox_torch.ops import cuda_lib

_P, _I, _L = cuda_lib.P, cuda_lib.I, cuda_lib.L
_SOLVE = (_P, _P, _P, _L, _I, _I, _P)
LIB = cuda_lib.CudaLibrary("chol_kernels", {
    "cholesky_f32": (_P, _P, _L, _I, _P),
    "cholesky_f64": (_P, _P, _L, _I, _P),
    "solve_lower_f32": _SOLVE, "solve_lower_f64": _SOLVE,
    "solve_lower_t_f32": _SOLVE, "solve_lower_t_f64": _SOLVE,
    "chol_cluster_fit_f32": (_I, _I, _I, _L, _I),
    "chol_cluster_fit_f64": (_I, _I, _I, _L, _I),
    "chol_design_f32": (_I, _L, _I, _I), "chol_design_f64": (_I, _L, _I, _I),
    "chol_max_shared_bytes": ()})


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# --------------------------------------------------------------------------


def cholesky_plain(H: torch.Tensor) -> torch.Tensor:
    """Right-looking column loop over the lower triangle, batched."""
    n = H.shape[-1]
    W = torch.tril(H).reshape(H.shape[:-2].numel(), n, n).clone()
    for j in range(n):
        dinv = 1.0 / torch.sqrt(W[:, j, j])
        col = W[:, j:, j] * dinv[:, None]
        W[:, j:, j] = col
        low = col[:, 1:]
        W[:, j + 1:, j + 1:] -= torch.tril(low[:, :, None] * low[:, None, :])
    return W.reshape(H.shape)


def _as_matrix(L: torch.Tensor, B: torch.Tensor, what: str):
    """(B as (..., n, K), whether B was a vector), checked against L."""
    vec = B.dim() == L.dim() - 1
    Bm = B[..., None] if vec else B
    n = L.shape[-1]
    if (L.shape[-2] != n or Bm.shape[:-1] != L.shape[:-1]
            or L.dtype != B.dtype or L.device != B.device):
        raise ValueError(f"{what}: factor {tuple(L.shape)} {L.dtype} and "
                         f"right-hand side {tuple(B.shape)} {B.dtype} do not "
                         "match")
    return Bm, vec


def _rows_and_steps(L: torch.Tensor, Bm: torch.Tensor):
    """The substitutions' operands as views, made once: X (nb, n, K) a copy
    of B, its rows (nb, K) and (nb, 1, K), the rows of L (nb, n, 1) and
    their diagonal entries (nb, 1)."""
    n, K = Bm.shape[-2], Bm.shape[-1]
    nb = L.shape[:-2].numel()
    Lm = L.reshape(nb, n, n)
    X = Bm.reshape(nb, n, K).clone()
    diag = torch.diagonal(Lm, dim1=1, dim2=2)[:, :, None].unbind(1)
    return (X, X.unbind(1), X.unsqueeze(1).unbind(2),
            Lm.unsqueeze(-1).unbind(1), Lm, diag)


def solve_lower_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Forward substitution, one column of L per step."""
    Bm, vec = _as_matrix(L, B, "solve_lower")
    n = Bm.shape[-2]
    X, row, rowu, _, Lm, diag = _rows_and_steps(L, Bm)
    col = Lm.unsqueeze(-1).unbind(2)              # column j: (nb, n, 1)
    for j in range(n):
        row[j].div_(diag[j])
        X.narrow(1, j + 1, n - j - 1).sub_(
            col[j].narrow(1, j + 1, n - j - 1) * rowu[j])
    X = X.reshape(Bm.shape)
    return X[..., 0] if vec else X


def solve_lower_t_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Back substitution with L', one row of L per step."""
    Bm, vec = _as_matrix(L, B, "solve_lower_t")
    n = Bm.shape[-2]
    X, row, rowu, lrow, _, diag = _rows_and_steps(L, Bm)
    for j in range(n - 1, -1, -1):
        row[j].div_(diag[j])
        X.narrow(1, 0, j).sub_(lrow[j].narrow(1, 0, j) * rowu[j])
    X = X.reshape(Bm.shape)
    return X[..., 0] if vec else X


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def cholesky(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n): the CUDA kernel on the card, the
    plain version on the CPU."""
    if H.device.type == "cpu":
        return cholesky_plain(H)
    cuda_lib.check_cuda(H, "cholesky")
    n = H.shape[-1]
    if H.dim() < 2 or H.shape[-2] != n:
        raise ValueError(f"cholesky: square matrices expected, got "
                         f"{tuple(H.shape)}")
    Hc = H.contiguous()
    out = torch.empty_like(Hc)
    nb = Hc.numel() // max(n * n, 1)
    if nb == 0 or n == 0:
        return out
    need = n * Hc.element_size() + 64
    with torch.cuda.device(H.device):
        cap = int(LIB.load().chol_max_shared_bytes())
    if need > cap:
        raise ValueError(f"cholesky: the kernel keeps a panel of at least one "
                         f"column in shared memory; n={n} {H.dtype} needs "
                         f"{need} bytes, the card allows {cap}")
    cuda_lib.launch(LIB, "cholesky", H.dtype, H.device, Hc.data_ptr(),
                    out.data_ptr(), nb, n)
    cholesky.launches += 1
    cuda_lib.record("cholesky", H.dtype, nb, n, n)
    return out


def _solve(wrapper, plain, L: torch.Tensor, B: torch.Tensor):
    name = wrapper.__name__
    if B.device.type == "cpu":
        return plain(L, B)
    cuda_lib.check_cuda(B, name)
    Bm, vec = _as_matrix(L, B, name)
    n, K = Bm.shape[-2], Bm.shape[-1]
    Lc, Bc = L.contiguous(), Bm.contiguous()
    X = torch.empty_like(Bc)
    nb = Bc.numel() // max(n * K, 1)
    if nb == 0 or n == 0 or K == 0:
        return X[..., 0] if vec else X
    cuda_lib.launch(LIB, name, B.dtype, B.device, Lc.data_ptr(),
                    Bc.data_ptr(), X.data_ptr(), nb, n, K)
    wrapper.launches += 1
    cuda_lib.record(name, B.dtype, nb, n, K)
    return X[..., 0] if vec else X


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Y with L Y = B (L lower triangular): the CUDA kernel on the card, the
    plain version on the CPU."""
    return _solve(solve_lower, solve_lower_plain, L, B)


def solve_lower_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X with L' X = B (L lower triangular, read in place): the CUDA kernel
    on the card, the plain version on the CPU."""
    return _solve(solve_lower_t, solve_lower_t_plain, L, B)


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L') X = B given the lower Cholesky factor: two launches."""
    return solve_lower_t(L, solve_lower(L, B))


cholesky.launches = 0
solve_lower.launches = 0
solve_lower_t.launches = 0
KERNELS = (cholesky, solve_lower, solve_lower_t)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
