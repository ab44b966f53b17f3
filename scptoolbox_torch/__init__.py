"""scptoolbox_torch: the PyTorch + CUDA port of scptoolbox_tpu.

Sequential convex programming (PTR, serial and batched) over a batched HSDE
interior-point conic solver, with the stage-structured cyclic-reduction KKT
running its small-block LU, and the dense Schur KKT its Cholesky ladder, on
hand-written CUDA kernels for NVIDIA Hopper (ops/lu_kernels.py,
ops/chol_kernels.py, csrc/). Entry points run on the card unless the caller
passes `device="cpu"`. Importing the package builds no kernel: the kernels
are built with nvcc at their first launch.
"""
