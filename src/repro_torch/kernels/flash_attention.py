"""Dense flash attention: q, k, v ``[B, H, L, hd]`` (GQA broadcast upstream).

Counterpart of ``repro/kernels/flash_attention.py``: ``causal`` masking with
whole key blocks past a query block's end skipped, a sliding ``window``
(``kpos > qpos - window``, causal or not) and ``softcap`` (``tanh(s / c)·c``
on the scaled logits, before the mask, when truthy), an online softmax in
f32 with masked logits ``NEG = -1e30``, the output in q's dtype. Block
sizes come from :func:`plan_blocks`, the reference's VMEM planner copied as
it is; the CUDA kernel tiles shared memory for itself and takes the blocks
only for the one case they decide: a row that sees no key returns the mean
of V over the keys of the blocks the reference runs for it.

:func:`flash_attention` dispatches by the device of its tensors:

  * CUDA — ``csrc/flash_attention.cu``, or an error: bf16 inputs on
    tensor cores (``mma.sync``, P fed as hi + lo bf16; hd 32, 64 or 128),
    f32 inputs on the CUDA-core kernel (hd 16, 32, 64 or 128);
    :func:`launch_shape` gives the launch from host ints only, so a call
    can be captured in a CUDA graph;
  * CPU — :func:`flash_attention_plain`, the reference's grid of blocks
    walked in PyTorch, causal block skip included;
  * ``meta`` (shapes alone: a dry run's traced pass) — no walk: an empty
    output, and the walk's :func:`plain_flops` reported as a launch
    reports them. At a prefill of 32768 tokens the walk is ~33 thousand
    blocks a layer of some 20 ops each, hours of a traced pass.

``flash_attention.launches`` counts calls that launched the CUDA kernel;
each launch reports :func:`plain_flops` to ``core/perf.py``'s counters.
Key positions at or past Lk are never attended (the reference reads
whatever pads a short last block there).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import heromem, perf
from repro_torch.kernels import _build, ref

NEG = ref.NEG
HEAD_DIMS = (32, 64, 128)           # both kernels
F32_HEAD_DIMS = (16,) + HEAD_DIMS   # the CUDA-core kernel also takes 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KEY_TILE = 64         # keys of a tile, both kernels
F32_ROWS = 64         # query rows of a block of the CUDA-core (f32) kernel
MMA_ROWS = 64         # of the tensor-core (bf16) kernel: 4 warps x 16 rows
MMA_STAGES = 2        # K / V tiles in flight in the tensor-core kernel


class LaunchShape(NamedTuple):
    """One launch of the kernel: ``rows`` query rows per block, ``threads``
    per block, ``blocks`` along the query axis (times B*H along the other),
    ``smem`` bytes of dynamic shared memory."""
    rows: int
    threads: int
    blocks: int
    smem: int


def launch_shape(L: int, hd: int, dtype: torch.dtype) -> LaunchShape:
    """The launch ``csrc/flash_attention.cu`` takes, from host ints only.

    bf16: 4 warps of 16 query rows each, the Q tile and :data:`MMA_STAGES`
    buffers of 64-key K and V tiles as bf16 rows padded by 8 elements.
    f32: 256 threads on a 64-row tile, Q / K padded by 4 floats, V, the
    logits [64][68], (m, l, rescale) and the run limits."""
    if dtype == torch.bfloat16:
        R = MMA_ROWS
        smem = (R + 2 * MMA_STAGES * KEY_TILE) * (hd + 8) * 2
        return LaunchShape(R, 128, -(-L // R), smem)
    R = F32_ROWS
    smem = ((R + KEY_TILE) * (hd + 4) + KEY_TILE * hd
            + R * (KEY_TILE + 4) + 3 * R) * 4 + R * 4
    return LaunchShape(R, 256, -(-L // R), smem)


BLOCKS = (128, 256, 512, 1024, 2048)    # plan_blocks' choices, each side


def plan_blocks(L: int, Lk: int, hd: int, itemsize: int = 4,
                budget: Optional[int] = None) -> Tuple[int, int]:
    """AutoDMA block planning for (q_blk, k_blk): maximize tiles subject to
    VMEM; lane/sublane-aligned. Scratch (m,l,acc) counted at f32."""
    budget = budget or heromem.hero_l1_capacity()
    best = (128, 128)
    best_steps = None
    for qb in BLOCKS:
        if L % qb and qb != L:
            continue
        for kb in BLOCKS:
            if Lk % kb and kb != Lk:
                continue
            qb_, kb_ = min(qb, L), min(kb, Lk)
            work = (qb_ * hd + 2 * kb_ * hd + qb_ * hd) * itemsize * 2
            scratch = (qb_ * hd + 2 * qb_) * 4 + qb_ * kb_ * 4
            if work + scratch > budget:
                continue
            steps = -(-L // qb_) * -(-Lk // kb_)
            if best_steps is None or steps < best_steps:
                best, best_steps = (qb_, kb_), steps
    return best


def _blocks(q, k, block_q, block_k) -> Tuple[int, int]:
    if block_q is None or block_k is None:
        pq, pk = plan_blocks(q.shape[2], k.shape[2], q.shape[3],
                             q.dtype.itemsize)
        block_q = block_q or pq
        block_k = block_k or pk
    return block_q, block_k


def plain_flops(BH: int, L: int, Lk: int, hd: int, causal: bool, bq: int,
                bk: int) -> int:
    """The FLOPs :func:`flash_attention_plain`'s matrix products count over
    the blocks it visits (past the causal frontier skipped): what a launch
    reports to ``core/perf.py``'s counters."""
    total = 0
    for q0 in range(0, L, bq):
        R = min(bq, L - q0)
        for k0 in range(0, Lk, bk):
            if causal and k0 > q0 + bq - 1:
                break
            total += 4 * BH * R * min(bk, Lk - k0) * hd
    return total


def flash_attention_plain(q, k, v, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          block_q: Optional[int] = None,
                          block_k: Optional[int] = None) -> torch.Tensor:
    """The reference kernel's grid walked in PyTorch: for each query block,
    the key blocks in order (past the causal frontier skipped), an online
    softmax from m = -inf. Returns [B, H, L, hd] in q's dtype."""
    B, H, L, hd = q.shape
    Lk = k.shape[2]
    bq, bk = _blocks(q, k, block_q, block_k)
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(B * H, L, hd)
    kr = k.reshape(B * H, Lk, hd)
    vr = v.reshape(B * H, Lk, hd)
    out = torch.empty_like(qr)
    for q0 in range(0, L, bq):
        qb = qr[:, q0:q0 + bq].float()                       # [BH, R, hd]
        R = qb.shape[1]
        m = torch.full((B * H, R), -math.inf, device=q.device)
        l = torch.zeros(B * H, R, device=q.device)
        acc = torch.zeros(B * H, R, hd, device=q.device)
        qpos = q0 + torch.arange(R, device=q.device)[:, None]
        for k0 in range(0, Lk, bk):
            if causal and k0 > q0 + bq - 1:
                break
            kb = kr[:, k0:k0 + bk].float()
            vb = vr[:, k0:k0 + bk].float()
            s = (qb @ kb.transpose(1, 2)) * scale             # [BH, R, C]
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            keep = torch.ones_like(s[0], dtype=torch.bool)
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= kpos > qpos - window
            s = torch.where(keep, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vb
            m = m_new
        out[:, q0:q0 + R] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.reshape(B, H, L, hd)


def _check_cuda(q, k, v) -> None:
    name = "flash_attention"
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{name}: all tensors must be on {q.device}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: tensors must be contiguous and 16-byte "
                         "aligned")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share one dtype in "
                        f"{tuple(DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, H, L, hd = q.shape
    if k.dim() != 4 or v.shape != k.shape or tuple(k.shape[:2]) != (B, H) \
            or k.shape[3] != hd or k.shape[2] == 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not fit")
    dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    if hd not in dims:
        raise ValueError(f"{name}: hd {hd} not in {dims} for {q.dtype}")
    if max(L, k.shape[2]) > 2**30 or B * H > 65535:
        raise ValueError(f"{name}: sizes past the kernel's int fields")


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q, k, v: [B, H, L, hd] and [B, H, Lk, hd] (GQA broadcast upstream).
    Returns [B, H, L, hd] in q's dtype. ``block_q`` / ``block_k`` default
    to :func:`plan_blocks`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, softcap,
                                     block_q, block_k)
    if q.device.type == "meta":            # shapes alone: count the walk
        B, H, L, hd = q.shape
        bq, bk = _blocks(q, k, block_q, block_k)
        perf.add_kernel_flops("flash_attention", plain_flops(
            B * H, L, k.shape[2], hd, causal, bq, bk))
        perf.add_kernel_scratch("flash_attention", 0)   # out alone
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda(q, k, v)
    B, H, L, hd = q.shape
    Lk = k.shape[2]
    bq, bk = _blocks(q, k, block_q, block_k)
    # a window past either end changes nothing further: keep it in an int
    w = 0 if window is None else min(max(int(window), -Lk), L + 1)
    shape = launch_shape(L, hd, q.dtype)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    err = lib.flash_attention(
        ptr(q), ptr(k), ptr(v), ptr(out), B * H, L, Lk, hd, int(causal),
        int(window is not None), w, bq, bk, DTYPES[q.dtype], shape.rows,
        shape.smem, ctypes.c_float(float(softcap or 0.0)),
        ctypes.c_void_p(stream))
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    perf.add_kernel_flops("flash_attention",
                          plain_flops(B * H, L, Lk, hd, causal, bq, bk))
    return out


flash_attention.launches = 0
