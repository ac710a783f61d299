"""Paper Table 2 linear-algebra kernels as AutoDMA-planned kernels.

Counterpart of ``repro/kernels/polybench.py:25-88``: ``matvec`` and
``matvec_t`` run through the builder (``core/autodma.tiled_call``) with
their CUDA bodies in ``csrc/autodma_tiled.cu``; 2mm, 3mm, atax and bicg
compose gemm/matvec passes on the host, like the paper's "consecutive
offloads" (→ arrows in Table 2). ``matvec.launches`` and
``matvec_t.launches`` count calls that launched the CUDA kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autodma
from repro_torch.kernels.gemm import gemm


def _fold(y: torch.Tensor, axis_info, partial: torch.Tensor) -> None:
    """y = prev + partial, with prev = 0 at reduction index 0."""
    jidx, _ = axis_info[1]
    y.copy_(partial if jidx == 0 else y.float() + partial)


def _matvec_body(a, x, y, *, axis_info):
    _fold(y, axis_info, a.float() @ x.float())


def _matvec_t_body(a, x, y, *, axis_info):
    _fold(y, axis_info, a.float().T @ x.float())


def matvec_t_spec(M: int, N: int, dtype=torch.float32) -> autodma.KernelSpec:
    """y = Aᵀx by column access: A [M, N] is read through dims (1, 0)."""
    return autodma.KernelSpec(
        name="matvec_t", loop_bounds=(N, M), reduction_axes=(1,),
        flops_per_point=2,
        arrays=(
            autodma.ArrayAccess("A", (M, N), (1, 0), dtype),
            autodma.ArrayAccess("x", (M,), (1,), dtype),
            autodma.ArrayAccess("y", (N,), (0,), dtype, is_output=True),
        ))


def matvec(A, x, mode="autodma", budget=None):
    """y = A·x. Returns (y, plan)."""
    M, N = A.shape
    spec = autodma.matvec_spec(M, N, dtype=A.dtype)
    call, p = autodma.tiled_call(autodma.Body("matvec", _matvec_body), spec,
                                 budget=budget, mode=mode)
    out = call(A, x)
    if A.device.type == "cuda":
        matvec.launches += 1
    return out, p


def matvec_t(A, x, mode="autodma", budget=None):
    """y = Aᵀ x without materializing Aᵀ (column-wise access — the paper's
    low-spatial-locality case). Returns (y, plan)."""
    M, N = A.shape
    spec = matvec_t_spec(M, N, dtype=A.dtype)
    call, p = autodma.tiled_call(autodma.Body("matvec_t", _matvec_t_body),
                                 spec, budget=budget, mode=mode)
    out = call(A, x)
    if A.device.type == "cuda":
        matvec_t.launches += 1
    return out, p


matvec.launches = 0
matvec_t.launches = 0


def mm2(A, B, C, alpha=1.0, mode="autodma", budget=None,
        handwritten_tiles: Optional[tuple] = None):
    tmp, p1 = gemm(A, B, alpha=alpha, mode=mode, budget=budget,
                   handwritten_tiles=handwritten_tiles)
    out, p2 = gemm(tmp, C, mode=mode, budget=budget,
                   handwritten_tiles=handwritten_tiles)
    return out, (p1, p2)


def mm3(A, B, C, D, mode="autodma", budget=None,
        handwritten_tiles: Optional[tuple] = None):
    E, p1 = gemm(A, B, mode=mode, budget=budget,
                 handwritten_tiles=handwritten_tiles)
    F, p2 = gemm(C, D, mode=mode, budget=budget,
                 handwritten_tiles=handwritten_tiles)
    G, p3 = gemm(E, F, mode=mode, budget=budget,
                 handwritten_tiles=handwritten_tiles)
    return G, (p1, p2, p3)


def atax(A, x, mode="autodma", budget=None):
    b, p1 = matvec(A, x, mode=mode, budget=budget)
    y, p2 = matvec_t(A, b, mode=mode, budget=budget)
    return y, (p1, p2)


def bicg(A, p_vec, r, mode="autodma", budget=None):
    q, p1 = matvec(A, p_vec, mode=mode, budget=budget)
    s, p2 = matvec_t(A, r, mode=mode, budget=budget)
    return (q, s), (p1, p2)
