"""Paper Table 2 kernel suite as AutoDMA-planned kernels.

Counterpart of ``repro/kernels/polybench.py``: ``matvec``, ``matvec_t``
and covar's two passes run through the builder (``core/autodma.tiled_call``)
with their CUDA bodies in ``csrc/autodma_tiled.cu``; 2mm, 3mm, atax and
bicg compose gemm/matvec passes on the host, like the paper's "consecutive
offloads" (→ arrows in Table 2); ``conv2d`` is a kernel of its own
(``csrc/conv2d_3x3.cu``), as its Pallas kernel is a ``pallas_call`` of its
own. ``matvec.launches``, ``matvec_t.launches``, ``conv2d.launches`` and
``covar.launches`` count calls that launched their CUDA kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core import autodma, heromem
from repro_torch.kernels import _build
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


# --------------------------------------------------------------------------
# conv2d — 3×3 stencil, row-tiled, halo rows from the ±1 neighbour tiles
# --------------------------------------------------------------------------
CONV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CONV_WARPS = 4          # warps of a kernel block, side by side along a row
CONV_DEPTH = 4          # rows a lane loads ahead; a band is a multiple
CONV_BAND = {torch.float32: 16, torch.bfloat16: 8}   # rows a warp walks
CONV_MAX_GRID_Y = 65535


class ConvLaunch(NamedTuple):
    vec: int            # columns a lane owns: 16 bytes, or 1 (scalar path)
    band: int           # rows a warp walks
    grid_x: int         # blocks along a row, CONV_WARPS segments each
    grid_y: int         # bands
    blocks: int


def conv2d_row_tile(H: int, W: int, row_tile: Optional[int] = None) -> int:
    """The reference's row tile: ``row_tile``, else as many rows as five
    f32 row blocks of width W fit in L1 (multiples of 8, at least 8),
    shrunk until it divides H."""
    bh = row_tile or min(H, max(8, (heromem.hero_l1_capacity() //
                                    (4 * W * 5)) // 8 * 8))
    while H % bh:
        bh -= 1
    return bh


def conv2d_launch(H: int, W: int, dtype=torch.float32,
                  aligned: bool = True) -> ConvLaunch:
    """The kernel's own tiling (every output is the same nine products in
    the same order whatever the tiling, so it need not be the reference's
    row tile): a warp walks a band of ``CONV_BAND[dtype]`` rows (more where
    the grid would pass 65535 bands) down a segment of 32 lanes; a lane
    owns 16 bytes of a row where W is a multiple of that and the rows
    start 16-byte ``aligned``, else one column."""
    full = 128 // torch.finfo(dtype).bits
    vec = full if aligned and W % full == 0 else 1
    rows = -(-H // CONV_MAX_GRID_Y)        # the least band the grid allows
    band = max(CONV_BAND[dtype], -(-rows // CONV_DEPTH) * CONV_DEPTH)
    gx = -(-W // (CONV_WARPS * 32 * vec))
    gy = -(-H // band)
    return ConvLaunch(vec, band, gx, gy, gx * gy)


def conv2d_plain(A: torch.Tensor, c: torch.Tensor, bh: int) -> torch.Tensor:
    """The kernel's function in PyTorch, walking the reference's grid of
    row tiles: each tile gets its halo rows from the tiles above and below
    (zeros at the edges), zero columns at both sides, and accumulates
    ``c[di, dj] · x`` in f32 in the order di, then dj."""
    H, W = A.shape
    n = H // bh
    out = torch.empty_like(A)
    zero = torch.zeros(1, W, dtype=A.dtype, device=A.device)
    for i in range(n):
        top = A[i * bh - 1:i * bh] if i > 0 else zero
        bot = A[(i + 1) * bh:(i + 1) * bh + 1] if i < n - 1 else zero
        x = torch.cat([top, A[i * bh:(i + 1) * bh], bot]).float()
        xp = torch.nn.functional.pad(x, (1, 1))
        acc = torch.zeros(bh, W, dtype=torch.float32, device=A.device)
        for di in range(3):
            for dj in range(3):
                acc += c[di, dj] * xp[di:di + bh, dj:dj + W]
        out[i * bh:(i + 1) * bh] = acc.to(A.dtype)
    return out


def conv2d(A: torch.Tensor, c3x3, mode: str = "autodma",
           budget: Optional[int] = None, row_tile: Optional[int] = None):
    """B = 3×3 stencil of A with zero borders, rows tiled. Returns (B, plan).

    A: [H, W] f32 or bf16; c3x3: [3, 3], taken as f32; B in A's dtype. As
    in the reference, the row tile comes from ``row_tile`` or the L1
    capacity, and ``mode`` changes only the returned plan
    (``autodma.plan`` of ``conv2d_3x3_spec``), never the kernel; ``budget``
    is read by neither. CUDA tensors launch ``csrc/conv2d_3x3.cu`` (in its
    own bands, :func:`conv2d_launch`: the row tile changes no bit) or
    raise; CPU tensors take :func:`conv2d_plain` over the row tiles.
    """
    H, W = A.shape
    c = torch.as_tensor(c3x3, dtype=torch.float32, device=A.device)
    if tuple(c.shape) != (3, 3):
        raise ValueError(f"conv2d: c3x3 must be [3, 3], got {tuple(c.shape)}")
    plan = autodma.plan(autodma.conv2d_3x3_spec(H, W, A.dtype), mode=mode)
    if A.device.type == "cpu":
        return conv2d_plain(A, c, conv2d_row_tile(H, W, row_tile)), plan
    if A.device.type != "cuda":
        raise ValueError(f"conv2d: unsupported device {A.device}")
    if A.dtype not in CONV_DTYPES:
        raise TypeError(f"conv2d: dtype {A.dtype} not in "
                        f"{tuple(CONV_DTYPES)}")
    if not A.is_contiguous():
        raise ValueError("conv2d: A must be contiguous")
    c = c.contiguous()
    out = torch.empty_like(A)
    shape = conv2d_launch(H, W, A.dtype, A.data_ptr() % 16 == 0
                          and out.data_ptr() % 16 == 0)
    lib = _build.load("conv2d_3x3")
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.conv2d_3x3(ctypes.c_void_p(A.data_ptr()),
                         ctypes.c_void_p(c.data_ptr()),
                         ctypes.c_void_p(out.data_ptr()), H, W, shape.band,
                         shape.vec, CONV_DTYPES[A.dtype],
                         ctypes.c_void_p(stream))
    _build.check("conv2d_3x3", err)
    conv2d.launches += 1
    return out, plan


conv2d.launches = 0


# --------------------------------------------------------------------------
# covar — two passes over the data (reload factor 2, paper §3.1)
# --------------------------------------------------------------------------
def _center_body(d, m, o, *, axis_info):
    o.copy_(d - m)


def _gram_body(d1, d2, s, *, axis_info, M):
    kidx, _ = axis_info[2]
    prev = 0.0 if kidx == 0 else s.float()
    s.copy_(prev + d1.float().T @ d2.float() / (M - 1))


def gram_spec(M: int, N: int, dtype=torch.float32) -> autodma.KernelSpec:
    """S = D1ᵀ D2 over grid (i, j, k): D1 [M, N] read through (2, 0)."""
    return autodma.KernelSpec(
        name="gram", loop_bounds=(N, N, M), reduction_axes=(2,),
        flops_per_point=2,
        arrays=(
            autodma.ArrayAccess("D1", (M, N), (2, 0), dtype),
            autodma.ArrayAccess("D2", (M, N), (2, 1), dtype),
            autodma.ArrayAccess("S", (N, N), (0, 1), dtype, is_output=True),
        ))


def covar(D: torch.Tensor, mode: str = "autodma",
          budget: Optional[int] = None):
    """S = DcᵀDc / (M−1) with Dc = D − column means. Returns (S, (p1, p2)).

    Pass 1 centres D through the builder's elementwise ``center`` body
    against the column means broadcast to [M, N] (the mean itself is a
    host-side reduction in the reference; here one ``torch.mean``); pass 2
    is the gram through the builder's ``gram`` body, which on the card
    scales each reduction step's TF32 product by alpha = 1/(M−1) where the
    reference divides it by M−1.
    """
    M, N = D.shape
    spec = autodma.elementwise_spec((M, N), n_in=2, dtype=D.dtype,
                                    name="center")
    call, p1 = autodma.tiled_call(autodma.Body("center", _center_body), spec,
                                  budget=budget, mode=mode)
    body = autodma.Body("gram", functools.partial(_gram_body, M=M),
                        alpha=1.0 / (M - 1))
    call2, p2 = autodma.tiled_call(body, gram_spec(M, N, D.dtype),
                                   budget=budget, mode=mode)
    out = _covar(D, call, call2)
    if D.device.type == "cuda":
        covar.launches += 1
    return out, (p1, p2)


covar.launches = 0


def _covar(D, center, gram):
    M, N = D.shape
    mean = D.mean(dim=0, keepdim=True)
    Dc = center(D, mean.expand(M, N).contiguous())
    return gram(Dc, Dc)


def covar_plain(D: torch.Tensor, p1: autodma.Plan, p2: autodma.Plan):
    """covar's plain version on any device: the grid walker over the plans
    ``p1`` (center) and ``p2`` (gram) that :func:`covar` returned."""
    gram = functools.partial(_gram_body, M=D.shape[0])
    return _covar(D, functools.partial(autodma.walk, _center_body, p1),
                  functools.partial(autodma.walk, gram, p2))
