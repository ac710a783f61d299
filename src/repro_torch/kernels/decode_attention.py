"""Flash-decode: one query token against a dense, ragged KV cache.

Counterpart of ``repro/kernels/decode_attention.py``. Slot b's query heads
attend the first ``lengths[b]`` positions of its cache ``[K, S, hd]``; GQA
groups G = H/K query heads per kv head (head h = k·G + g).

The numeric contract is the reference kernel's: masked logits are
``NEG = -1e30`` and their probabilities are not zeroed, so a slot of length
0 returns the mean of V over all S positions (the paged kernels return 0
there instead).

:func:`flash_decode` dispatches by the device of its tensors:

  * CUDA — the hand-written kernel ``csrc/decode_attention.cu`` (split over
    the key axis, then a merge of the splits), or an error;
  * CPU — :func:`flash_decode_plain`, the reference's online softmax over
    ``block_k`` tiles written out in PyTorch.

``flash_decode.launches`` counts calls that launched the CUDA kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

NEG = ref.NEG
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TILE = 64        # keys the kernel stages at a time; a split holds whole tiles


def decode_block_k(S: int, block_k: int = 512) -> int:
    """The reference's key tile: ``block_k``, at most S, shrunk until it
    divides S."""
    block_k = min(block_k, S)
    while S % block_k:
        block_k -= 1
    return block_k


def decode_splits(pairs: int, S: int, n_sm: int) -> tuple:
    """(splits, keys per split) of the kernel's key axis: enough splits that
    the ``pairs`` (slot, kv head) blocks come to two per SM, in whole
    ``SPLIT_TILE``-key tiles."""
    tiles = -(-S // SPLIT_TILE)
    want = min(tiles, max(1, -(-2 * n_sm // pairs)))
    chunk = -(-tiles // want) * SPLIT_TILE
    return -(-S // chunk), chunk


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """Oracle: masked softmax over the whole cache (``ref.decode_attention``)."""
    return ref.decode_attention(q, k_cache, v_cache, lengths)


def flash_decode_plain(q, k_cache, v_cache, lengths, block_k: int = 512):
    """The reference kernel's function in PyTorch: an online softmax in f32
    over ``block_k`` tiles of the cache (m from -inf, masked logits NEG).
    Returns [B, H, hd] in q's dtype."""
    B, H, hd = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    bk = decode_block_k(S, block_k)
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, G, hd).float()
    m = torch.full((B, K, G), -math.inf, device=q.device)
    l = torch.zeros(B, K, G, device=q.device)
    acc = torch.zeros(B, K, G, hd, device=q.device)
    lens = lengths.to(q.device).long()[:, None, None, None]
    for j in range(S // bk):
        kb = k_cache[:, :, j * bk:(j + 1) * bk].float()         # [B, K, bk, hd]
        vb = v_cache[:, :, j * bk:(j + 1) * bk].float()
        s = (qg @ kb.transpose(-1, -2)) * scale                 # [B, K, G, bk]
        kpos = j * bk + torch.arange(bk, device=q.device)
        s = torch.where(kpos < lens, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def _check_cuda(q, k_cache, v_cache, lengths) -> None:
    name = "flash_decode"
    tensors = (q, k_cache, v_cache, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {q.device}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous and 16-byte "
                         "aligned")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share one dtype in "
                        f"{tuple(DTYPES)}, got {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    B, H, hd = q.shape
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: k/v caches must be [B, K, S, hd] alike")
    _, K, S, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != hd or H % K or S == 0 \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not fit")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: hd {hd} not in {HEAD_DIMS}")


def flash_decode(q, k_cache, v_cache, lengths, block_k: int = 512):
    """One-token GQA attention over a dense ragged cache.

    q:       [B, H, hd]
    k_cache: [B, K, S, hd]
    v_cache: [B, K, S, hd]
    lengths: [B] int32 valid positions (0 gives the mean of V over S)
    block_k: the reference's key tile; the plain version walks it, the CUDA
             kernel tiles for itself (only the sums' order depends on it)
    Returns [B, H, hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    _check_cuda(q, k_cache, v_cache, lengths)
    B, H, hd = q.shape
    _, K, S, _ = k_cache.shape
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, chunk = decode_splits(B * K, S, n_sm)
    out = torch.empty_like(q)
    part_ml = torch.empty(2 * B * H * nsplit, device=q.device)
    part_acc = torch.empty(B * H * nsplit * hd, device=q.device)
    lib = _build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    err = lib.decode_attention(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(lengths), ptr(out),
        ptr(part_ml), ptr(part_acc), B, H, K, S, hd, nsplit, chunk,
        DTYPES[q.dtype], ctypes.c_void_p(stream))
    _build.check("decode_attention", err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
