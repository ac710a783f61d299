"""Tiled GEMM — the paper's central accelerated kernel (gemm/darknet in
Table 2), with AutoDMA-planned shared-memory tiling.

Counterpart of ``repro/kernels/gemm.py``. The body variants map HEROv2's
§3.4 ISA study onto the H100's units (``csrc/autodma_tiled.cu``):

  * body="mxu"  — tensor cores, ``mma.sync`` (TF32 for f32, bf16 for bf16)
                  with f32 accumulation (≈ Xpulpv2's fused MAC);
  * body="vpu"  — multiply, then add, on CUDA cores, no fused multiply-add
                  (≈ scalar mul + add on RV32IMAFC, no MAC instruction);
  * body="loop" — FFMA on CUDA cores in a software k-loop over 8-deep
                  slices, kept rolled (≈ a software loop against the
                  hardware loop).

Each body's plain PyTorch form below is what the grid walker runs for CPU
tensors; all keep the JAX bodies' contract: zero at reduction index 0,
``alpha`` applied per reduction step, the output block in A's dtype.
``gemm.launches`` counts calls that launched the CUDA kernel.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.core import autodma

# the plain vpu body's broadcast product is cut into k-chunks of at most
# this many elements (a whole [tm, tk, tn] product can be tens of GB)
VPU_CHUNK_ELEMS = 1 << 24


def _prev(c: torch.Tensor, axis_info, axis: int):
    kidx, _ = axis_info[axis]
    return 0.0 if kidx == 0 else c.float()


def _body_mxu(a, b, c, *, axis_info, alpha):
    prev = _prev(c, axis_info, 2)
    c.copy_(prev + alpha * (a.float() @ b.float()))


def _body_vpu(a, b, c, *, axis_info, alpha):
    prev = _prev(c, axis_info, 2)
    a32, b32 = a.float(), b.float()
    acc = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
    step = max(1, VPU_CHUNK_ELEMS // max(1, c.numel()))
    for k0 in range(0, a.shape[1], step):
        # elementwise multiply + reduction: no matrix unit
        acc += (a32[:, k0:k0 + step, None] * b32[None, k0:k0 + step, :]).sum(1)
    c.copy_(prev + alpha * acc)


def _body_loop(a, b, c, *, axis_info, alpha, unroll_k: int = 8):
    """k-slices of 8; a last partial slice is included (the JAX body's
    ``fori_loop`` over ``Kb // 8`` slices leaves it out)."""
    prev = _prev(c, axis_info, 2)
    a32, b32 = a.float(), b.float()
    acc = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
    for k0 in range(0, a.shape[1], unroll_k):
        acc = acc + a32[:, k0:k0 + unroll_k] @ b32[k0:k0 + unroll_k]
    c.copy_(prev + alpha * acc)


BODIES = {"mxu": _body_mxu, "vpu": _body_vpu, "loop": _body_loop}


def gemm(A: torch.Tensor, B: torch.Tensor, alpha: float = 1.0,
         mode: str = "autodma", body: str = "mxu",
         budget: Optional[int] = None, plan: Optional[autodma.Plan] = None,
         handwritten_tiles: Optional[tuple] = None):
    """C = alpha·A·B with AutoDMA-planned (or handwritten) tiles.

    mode: "autodma" | "paper" | "unmodified" (whole-array blocks).
    handwritten_tiles: (tm, tn, tk) expert override → mode="handwritten".
    Returns (C, plan).
    """
    M, K = A.shape
    K2, N = B.shape
    if K != K2:
        raise ValueError(f"gemm: A {tuple(A.shape)} and B {tuple(B.shape)}")
    if body not in BODIES:
        raise ValueError(f"gemm: body {body!r} not in {tuple(BODIES)}")
    spec = autodma.matmul_spec(M, N, K, dtype=A.dtype)
    if handwritten_tiles is not None:
        p = _plan_with_tiles(spec, handwritten_tiles)
    elif plan is not None:
        p = plan
    else:
        p = autodma.plan(spec, budget=budget, mode=mode)
    kernel = autodma.Body(cuda=f"gemm_{body}", alpha=alpha,
                          plain=functools.partial(BODIES[body], alpha=alpha))
    call, p = autodma.tiled_call(kernel, spec, plan_=p)
    out = call(A, B)
    if A.device.type == "cuda":
        gemm.launches += 1
    return out, p


gemm.launches = 0


def _plan_with_tiles(spec, tiles):
    """Handwritten mode: expert-chosen tiles through the same Plan plumbing
    (counted double-buffered, rows assumed contiguous)."""
    nt = [-(-b // t) for b, t in zip(spec.loop_bounds, tiles)]
    par = [g for g in range(len(tiles)) if g not in spec.reduction_axes]
    order = par + list(spec.reduction_axes)
    pos = {ax: i for i, ax in enumerate(order)}
    block_shapes = {
        a.name: tuple(a.shape[d] if ax == autodma.FULL else min(tiles[ax], a.shape[d])
                      for d, ax in enumerate(a.dims))
        for a in spec.arrays}
    vmem = sum(math.prod(block_shapes[a.name]) * a.itemsize for a in spec.arrays) * 2
    bursts, reconf = autodma._bursts(spec, tiles, True)
    return autodma.Plan(spec=spec, tiles=tuple(tiles),
                        grid=tuple(nt[g] for g in order),
                        grid_axes=tuple(order), block_shapes=block_shapes,
                        index_maps=autodma._index_maps(spec, pos),
                        traffic_bytes=autodma._traffic(spec, tiles),
                        vmem_bytes=vmem, dma_bursts=bursts,
                        dma_reconfigs=reconf, mode="handwritten")
