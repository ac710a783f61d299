"""Paged flash-decode: one-token GQA attention over a page-table KV pool.

Counterpart of ``repro/kernels/paged_decode_attention.py``. The KV cache is
a pool of physical pages ``[P, K, pt, hd]``; slot b owns the ordered page
list ``page_table[b]`` (-1 = unmapped, never read below the slot's length).

:func:`paged_flash_decode` dispatches by the device of its tensors:

  * CUDA — the hand-written kernel ``csrc/paged_decode_attention.cu``
    (built on first use, see kernels/_build.py): the page walk split over
    blocks as :func:`decode_grid` says, then a merge of the splits, two
    launches; or an error: there is no fallback to the plain version on the
    card;
  * CPU — :func:`paged_flash_decode_plain`, the same function from a gather
    and a masked softmax.

``paged_flash_decode.launches`` counts wrapper calls that launched the
kernel (plain calls and failed launches do not count).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
PAGE_TOKENS = (4, 8, 16, 32, 64)
PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}


SPLIT_BLOCKS_PER_SM = 4   # split the page walk until blocks come to this
ROWS_PER_BLOCK = 8        # query rows of one kv head in a decode block


class DecodeGrid(NamedTuple):
    """The decode kernel's launch: ``nsplit`` splits of ``pages_per_split``
    pages for each (slot, kv head, group of 8 query rows), ``blocks`` blocks
    in all, and the f32 scratch of the splits' partials (``part_ml``: m and
    l, ``part_acc``: acc) in elements."""
    nsplit: int
    pages_per_split: int
    blocks: int
    part_ml: int
    part_acc: int


def decode_grid(B: int, H: int, K: int, hd: int, max_pages: int,
                n_sm: int) -> DecodeGrid:
    """Split the page axis until the blocks come to about
    ``SPLIT_BLOCKS_PER_SM`` per SM. Host ints only: ``lengths`` lives on the
    device, and reading it would sync and break CUDA-graph capture; a split
    past a slot's length exits at once instead."""
    pairs = max(1, B * K * -(-(H // K) // ROWS_PER_BLOCK))  # B = 0: no launch
    want = min(max_pages, max(1, -(-SPLIT_BLOCKS_PER_SM * n_sm // pairs)))
    pps = -(-max_pages // want)
    nsplit = -(-max_pages // pps)
    return DecodeGrid(nsplit, pps, nsplit * pairs, 2 * B * H * nsplit,
                      B * H * nsplit * hd)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Materialise a dense [B, K, max_pages·pt, hd] cache from the page pool
    (oracle and plain version; the kernel never does this)."""
    B, max_pages = page_table.shape
    _, K, pt, hd = pages.shape
    ids = page_table.clamp_min(0).reshape(-1).long()
    dense = pages.index_select(0, ids).reshape(B, max_pages, K, pt, hd)
    return dense.permute(0, 2, 1, 3, 4).reshape(B, K, max_pages * pt, hd)


def dequant_pages(pages: torch.Tensor, page_scale: torch.Tensor) -> torch.Tensor:
    """Dequantise an int8 page pool: [P, K, pt, hd] × [P, K] → f32."""
    return pages.float() * page_scale[:, :, None, None]


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths,
                               k_scale=None, v_scale=None):
    """Oracle: gather pages dense (dequantising first when scales are
    given), then the masked-softmax decode oracle."""
    if k_scale is not None:
        k_pages = dequant_pages(k_pages, k_scale)
        v_pages = dequant_pages(v_pages, v_scale)
    return ref.decode_attention(q, gather_pages(k_pages, page_table),
                                gather_pages(v_pages, page_table), lengths)


def check_scales(name: str, k_scale, v_scale) -> bool:
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError(f"{name}: k_scale and v_scale must be given together")
    return quant


def paged_flash_decode_plain(q, k_pages, v_pages, page_table, lengths,
                             k_scale=None, v_scale=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather, masked softmax in
    f32, a length-0 slot gives zeros. Returns [B, H, hd] in q's dtype."""
    check_scales("paged_flash_decode", k_scale, v_scale)
    B, H, hd = q.shape
    K = k_pages.shape[1]
    G = H // K
    if k_scale is not None:
        k_pages = dequant_pages(k_pages, k_scale)
        v_pages = dequant_pages(v_pages, v_scale)
    k = gather_pages(k_pages, page_table).float()            # [B, K, S, hd]
    v = gather_pages(v_pages, page_table).float()
    qg = q.reshape(B, K, G, hd).float()
    logits = (qg @ k.transpose(-1, -2)) / math.sqrt(hd)      # [B, K, G, S]
    pos = torch.arange(k.shape[2], device=q.device)
    visible = (pos[None, :] < lengths.long()[:, None])[:, None, None, :]
    out = ref.masked_attend(logits, visible, v)              # [B, K, G, hd]
    return out.reshape(B, H, hd).to(q.dtype)


def check_cuda_inputs(name: str, q, k_pages, v_pages, tables, scales,
                      ) -> int:
    """Validate what the CUDA kernels take; returns the page dtype code."""
    tensors = [q, k_pages, v_pages, *tables, *[s for s in scales
                                               if s is not None]]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {q.device}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError(f"{name}: q and the page pools must be 16-byte "
                         "aligned")
    if q.dtype != torch.float32:
        raise TypeError(f"{name}: q must be float32 on CUDA, got {q.dtype}")
    if k_pages.dtype not in PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{name}: page dtype {k_pages.dtype}/{v_pages.dtype} "
                        f"not in {tuple(PAGE_DTYPES)}")
    if (k_pages.dtype == torch.int8) != (scales[0] is not None):
        raise TypeError(f"{name}: int8 pages need scales, and only int8 "
                        "pages take them")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError(f"{name}: page table and lengths must be int32")
    if any(s is not None and s.dtype != torch.float32 for s in scales):
        raise TypeError(f"{name}: scales must be float32")
    P, K, pt, hd = k_pages.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: k/v page shapes differ")
    if hd not in HEAD_DIMS or pt not in PAGE_TOKENS:
        raise ValueError(f"{name}: hd {hd} / pt {pt} outside "
                         f"{HEAD_DIMS} / {PAGE_TOKENS}")
    if q.shape[-1] != hd or q.shape[-2] % K:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    for s in scales:
        if s is not None and tuple(s.shape) != (P, K):
            raise ValueError(f"{name}: scale shape {tuple(s.shape)} != "
                             f"{(P, K)}")
    return PAGE_DTYPES[k_pages.dtype]


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def paged_flash_decode(q, k_pages, v_pages, page_table, lengths,
                       k_scale=None, v_scale=None) -> torch.Tensor:
    """One-token attention over a paged KV cache.

    q:          [B, H, hd] (f32 on CUDA)
    k_pages:    [P, K, pt, hd] physical page pool (bf16/f16/f32, or int8)
    v_pages:    [P, K, pt, hd]
    page_table: [B, max_pages] int32 page ids, -1 = unmapped
    lengths:    [B] int32 valid token counts (0 gives a zero row)
    k_scale:    optional [P, K] f32 per-(page, kv-head) scales of an int8
                pool, dequantised inside the kernel
    v_scale:    optional [P, K] f32 (must accompany ``k_scale``)
    Returns [B, H, hd] in q's dtype.
    """
    check_scales("paged_flash_decode", k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, page_table,
                                        lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    code = check_cuda_inputs("paged_flash_decode", q, k_pages, v_pages,
                             (page_table, lengths), (k_scale, v_scale))
    B, H, hd = q.shape
    _, K, pt, _ = k_pages.shape
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError("paged_flash_decode: page_table must be [B, "
                         "max_pages] and lengths [B]")
    max_pages = page_table.shape[1]
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    grid = decode_grid(B, H, K, hd, max_pages, n_sm)
    out = torch.empty_like(q)
    part_ml = torch.empty(grid.part_ml, device=q.device)
    part_acc = torch.empty(grid.part_acc, device=q.device)
    lib = _build.load("paged_decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_decode_attention(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(page_table), _ptr(lengths), _ptr(out), _ptr(part_ml),
        _ptr(part_acc), B, H, K, hd, pt, max_pages, grid.nsplit,
        grid.pages_per_split, code, ctypes.c_void_p(stream))
    _build.check("paged_decode_attention", err)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
