"""PyTorch + CUDA port of the multigrid_petsc_tpu Poisson framework.

The JAX package ``multigrid_petsc_tpu`` is the reference this package is
held against; this package imports torch and numpy only.
"""
