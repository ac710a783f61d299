"""Paged flash-prefill: a chunk of queries against its sequence's paged prefix.

Counterpart of ``repro/kernels/paged_prefill_attention.py``. A prompt chunk
of C queries at global positions ``start .. start+C-1`` attends the
sequence's pages with a causal frontier that is exact across chunks: query
row r (chunk position r // G) sees keys at positions ``<= start + r // G``,
whether an earlier chunk or this one wrote them (the chunk's own K/V is
scattered in before the call).

:func:`paged_flash_prefill` dispatches by device as paged_flash_decode
does: CUDA tensors launch ``csrc/paged_prefill_attention.cu`` or raise, CPU
tensors take :func:`paged_flash_prefill_plain`.
``paged_flash_prefill.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
import operator

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.paged_decode_attention import (
    _ptr, check_cuda_inputs, check_scales, dequant_pages, gather_pages)


def _dense_prefix(k_pages, v_pages, page_table, k_scale, v_scale):
    if k_scale is not None:
        k_pages = dequant_pages(k_pages, k_scale)
        v_pages = dequant_pages(v_pages, v_scale)
    k = gather_pages(k_pages, page_table[None])[0].float()   # [K, S, hd]
    v = gather_pages(v_pages, page_table[None])[0].float()
    return k, v


def paged_prefill_attention_ref(q, k_pages, v_pages, page_table, start,
                                k_scale=None, v_scale=None):
    """Oracle: gather the pages dense (dequantising first when scales are
    given), softmax with the same cross-chunk causal frontier."""
    C, H, hd = q.shape
    K = k_pages.shape[1]
    G = H // K
    k, v = _dense_prefix(k_pages, v_pages, page_table, k_scale, v_scale)
    S = k.shape[1]
    qg = q.reshape(C, K, G, hd).float()
    logits = torch.einsum("ckgd,ksd->kgcs", qg, k) / math.sqrt(hd)
    qpos = int(start) + torch.arange(C, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    logits = logits.masked_fill(~(kpos <= qpos), ref.NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("kgcs,ksd->ckgd", p, v)
    return out.reshape(C, H, hd).to(q.dtype)


def paged_flash_prefill_plain(q, k_pages, v_pages, page_table, start,
                              k_scale=None, v_scale=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather, masked softmax in
    f32 with the cross-chunk causal frontier. Returns [C, H, hd]."""
    check_scales("paged_flash_prefill", k_scale, v_scale)
    start = operator.index(start)
    C, H, hd = q.shape
    K = k_pages.shape[1]
    G = H // K
    k, v = _dense_prefix(k_pages, v_pages, page_table, k_scale, v_scale)
    qg = q.reshape(C, K, G, hd).float().permute(1, 2, 0, 3)  # [K, G, C, hd]
    logits = (qg @ k[:, None].transpose(-1, -2)) / math.sqrt(hd)
    qpos = start + torch.arange(C, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    out = ref.masked_attend(logits, kpos <= qpos, v[:, None])  # [K,G,C,hd]
    return out.permute(2, 0, 1, 3).reshape(C, H, hd).to(q.dtype)


def paged_flash_prefill(q, k_pages, v_pages, page_table, start,
                        k_scale=None, v_scale=None) -> torch.Tensor:
    """Chunk attention over a paged KV cache with cross-chunk causal masking.

    q:          [C, H, hd] chunk queries at positions ``start .. start+C-1``
                (f32 on CUDA)
    k_pages:    [P, K, pt, hd] page pool holding the chunk's own K/V already
    v_pages:    [P, K, pt, hd]
    page_table: [max_pages] int32 page ids of this sequence, -1 = unmapped
    start:      host int — KV rows that precede this chunk
    k_scale:    optional [P, K] f32 scales of an int8 pool
    v_scale:    optional [P, K] f32 (must accompany ``k_scale``)
    Returns [C, H, hd] in q's dtype.
    """
    check_scales("paged_flash_prefill", k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, k_pages, v_pages, page_table,
                                         start, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_prefill: unsupported device {q.device}")
    if not isinstance(start, int):
        raise TypeError("paged_flash_prefill: start must be a host int on "
                        "CUDA (reading a device scalar would sync)")
    code = check_cuda_inputs("paged_flash_prefill", q, k_pages, v_pages,
                             (page_table,), (k_scale, v_scale))
    if page_table.dim() != 1:
        raise ValueError("paged_flash_prefill: page_table must be [max_pages]")
    C, H, hd = q.shape
    _, K, pt, _ = k_pages.shape
    out = torch.empty_like(q)
    lib = _build.load("paged_prefill_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_prefill_attention(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(page_table), _ptr(out), C, H, K, hd, pt, page_table.shape[0],
        start, code, ctypes.c_void_p(stream))
    _build.check("paged_prefill_attention", err)
    paged_flash_prefill.launches += 1
    return out


paged_flash_prefill.launches = 0
