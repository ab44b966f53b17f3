"""scptoolbox_torch: the PyTorch + CUDA port of scptoolbox_tpu.

Sequential convex programming (PTR, SCvx and GuSTO, serial and batched, and
PTR scenario batches over torch.distributed ranks) over a batched HSDE
interior-point conic solver, with the stage-structured KKT sweeps running
their small-block LU, and the dense Schur KKT and the block sweep their
Cholesky ladder, on hand-written CUDA kernels for NVIDIA Hopper
(ops/lu_kernels.py, ops/chol_kernels.py, csrc/); a host C++ IPM
(native.py) for small programs. Entry points run on the card unless the
caller passes `device="cpu"`. Importing the package builds no kernel and
imports no matplotlib: the kernels are built with nvcc at their first
launch, the host IPM with g++ at its first solve.
"""

from scptoolbox_torch.config import SCPError, SCPStatus

__version__ = "0.1.0"

__all__ = ["SCPStatus", "SCPError", "__version__"]
