"""PyTorch/CUDA port of the ``repro`` serving stack for one NVIDIA H100.

The layout mirrors ``repro`` module for module. This package imports
``torch`` and numpy only: it never imports ``jax`` or anything of ``repro``
(the tests hold it against ``repro``; the package itself stands alone).
Kernels dispatch by tensor device: a CUDA tensor launches the hand-written
CUDA kernel or raises, a CPU tensor takes the kernel's plain PyTorch version.
"""
