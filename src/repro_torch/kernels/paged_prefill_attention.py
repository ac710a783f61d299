"""Paged flash-prefill: a chunk of queries against its sequence's paged prefix.

Counterpart of ``repro/kernels/paged_prefill_attention.py``. A prompt chunk
of C queries at global positions ``start .. start+C-1`` attends the
sequence's pages with a causal frontier that is exact across chunks: query
row r (chunk position r // G) sees keys at positions ``<= start + r // G``,
whether an earlier chunk or this one wrote them (the chunk's own K/V is
scattered in before the call).

:func:`paged_flash_prefill` dispatches by device as paged_flash_decode
does: CUDA tensors launch ``csrc/paged_prefill_attention.cu`` or raise, CPU
tensors take :func:`paged_flash_prefill_plain`. On the card the page dtype
picks the kernel: bf16 / f16 pages the tensor-core one (split over keys as
:func:`prefill_grid` says, with a merge launch when it splits), f32 / int8
pages the CUDA-core one. ``paged_flash_prefill.launches`` counts wrapper
calls that launched a kernel.
"""
from __future__ import annotations

import ctypes
import math
import operator
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.paged_decode_attention import (
    _ptr, check_cuda_inputs, check_scales, dequant_pages, gather_pages)

ROW_TILE = 64           # query rows per block (4 warps x 16)
KEY_TILE = 64           # keys per tile of the tensor-core kernel
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)
SPLIT_BLOCKS_PER_SM = 2  # split the key axis until blocks come to this


class PrefillGrid(NamedTuple):
    """The prefill kernel's launch: ``nsplit`` splits of the key axis, each
    ``tiles_per_split`` tiles of 64 keys, for each (row tile, kv head);
    ``blocks`` blocks in all; f32 scratch of the partials in elements (0
    when the kernel does not split)."""
    nsplit: int
    tiles_per_split: int
    blocks: int
    part_ml: int
    part_acc: int


def prefill_grid(C: int, H: int, K: int, hd: int, pt: int, max_pages: int,
                 start: int, n_sm: int, dtype: torch.dtype) -> PrefillGrid:
    """Tensor-core pages (bf16 / f16): 64-row tiles, and the key axis split
    into runs of whole 64-key tiles until the blocks reach
    ``SPLIT_BLOCKS_PER_SM`` per SM where the keys allow, from host ints
    only. f32 / int8 pages: the CUDA-core kernel's grid, one block
    per (kv head, 64 rows), no split."""
    rows = max(1, C * (H // K))      # C = 0 launches nothing
    keys = min(start + C, max_pages * pt)
    tiles = max(1, -(-keys // KEY_TILE))
    if dtype not in TENSOR_CORE_DTYPES:
        return PrefillGrid(1, tiles, K * -(-rows // min(ROW_TILE, rows)), 0,
                           0)
    base = K * -(-rows // ROW_TILE)
    target = SPLIT_BLOCKS_PER_SM * n_sm
    want = min(tiles, max(1, -(-target // base)))
    tps = -(-tiles // want)
    while tps > 1 and base * -(-tiles // tps) < target:  # ceil cut a split
        tps -= 1
    nsplit = -(-tiles // tps)
    scratch = C * H * nsplit if nsplit > 1 else 0
    return PrefillGrid(nsplit, tps, base * nsplit, 2 * scratch,
                       scratch * hd)


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
    max_pages = page_table.shape[0]
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    grid = prefill_grid(C, H, K, hd, pt, max_pages, start, n_sm,
                        k_pages.dtype)
    out = torch.empty_like(q)
    part_ml = torch.empty(grid.part_ml, device=q.device) \
        if grid.part_ml else None
    part_acc = torch.empty(grid.part_acc, device=q.device) \
        if grid.part_acc else None
    lib = _build.load("paged_prefill_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_prefill_attention(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(page_table), _ptr(out), _ptr(part_ml), _ptr(part_acc), C, H, K,
        hd, pt, max_pages, start, grid.nsplit, grid.tiles_per_split, code,
        ctypes.c_void_p(stream))
    _build.check("paged_prefill_attention", err)
    paged_flash_prefill.launches += 1
    return out


paged_flash_prefill.launches = 0
