"""Flash-decode: one query token against a dense, ragged KV cache.

Counterpart of ``repro/kernels/decode_attention.py``. Slot b's query heads
attend the first ``lengths[b]`` positions of its cache ``[K, S, hd]``; GQA
groups G = H/K query heads per kv head (head h = k·G + g).

The numeric contract is the reference kernel's: masked logits are
``NEG = -1e30`` and their probabilities are not zeroed, so a slot of length
0 returns the mean of V over all S positions (the paged kernels return 0
there instead).

:func:`flash_decode` dispatches by the device of its tensors:

  * CUDA — the hand-written kernel ``csrc/decode_attention.cu``, or an
    error: one launch that splits the key axis over blocks, the last block
    of each (slot, kv head) merging the splits;
  * CPU — :func:`flash_decode_plain`, the reference's online softmax over
    ``block_k`` tiles written out in PyTorch.

``flash_decode.launches`` counts calls that launched the CUDA kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple

import torch

from repro_torch.kernels import _build, ref

NEG = ref.NEG
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS_PER_BLOCK = 8     # query rows of one kv head a block takes
BLOCKS_PER_SM = 2      # the split's target (2, 4, 8 timed: 2 was fastest)
MIN_SPLIT = 64         # keys; a split holds a whole number of them
MAX_SPLITS = 256       # the merge keeps its weights in shared memory


def decode_block_k(S: int, block_k: int = 512) -> int:
    """The reference's key tile: ``block_k``, at most S, shrunk until it
    divides S."""
    block_k = min(block_k, S)
    while S % block_k:
        block_k -= 1
    return block_k


class DecodeLaunch(NamedTuple):
    nsplit: int        # splits of the key axis (grid x)
    chunk: int         # keys per split
    groups: int        # row groups of ROWS_PER_BLOCK query rows (grid z)
    blocks: int
    counters: int      # int32 arrival counters, one per (slot, kv head, group)
    part_ml: int       # f32 scratch: m and l of every (slot, head, split)
    part_acc: int      # f32 scratch: acc of every (slot, head, split)


def decode_launch(B: int, H: int, K: int, S: int, hd: int,
                  n_sm: int) -> DecodeLaunch:
    """The kernel's launch shape from host ints only (``lengths`` lives on
    the device: reading it would sync and break CUDA-graph capture): split
    the key axis, in whole ``MIN_SPLIT``-key runs and at most
    ``MAX_SPLITS`` splits, until the blocks come to ``BLOCKS_PER_SM`` per
    SM; a split past a slot's length exits at once."""
    groups = -(-(H // K) // ROWS_PER_BLOCK)
    pairs = max(1, B * K * groups)                       # B = 0: no launch
    runs = -(-S // MIN_SPLIT)
    want = min(runs, MAX_SPLITS, max(1, -(-BLOCKS_PER_SM * n_sm // pairs)))
    chunk = -(-runs // want) * MIN_SPLIT
    nsplit = -(-S // chunk)
    return DecodeLaunch(nsplit, chunk, groups, nsplit * B * K * groups,
                        B * K * groups, 2 * B * H * nsplit,
                        B * H * nsplit * hd)


# device -> the kernel's int32 arrival counters, zero between calls. Every
# buffer ever made is kept: a captured CUDA graph holds its address.
_COUNTERS: Dict[torch.device, List[torch.Tensor]] = {}


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``, made on an eager
    call and reused by every later one, graph captures included (a buffer
    made inside a capture would belong to the graph's memory pool).

    One stream at a time: every call on a device shares these counters, so
    two calls whose kernels overlap in time (on two streams, or graph
    replays on two streams) would count each other's blocks. A block could
    then take itself for the last of its (slot, kv head) and merge partials
    not yet written, and the counters would not return to 0, spoiling the
    calls after. Calls and replays on one stream are ordered and safe."""
    bufs = _COUNTERS.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_decode: make one eager call at this shape before "
                "capturing it in a CUDA graph (its arrival counters are "
                "made outside any graph)")
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return bufs[-1]


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
    shape = decode_launch(B, H, K, S, hd, n_sm)
    counters = arrival_counters(q.device, shape.counters)
    out = torch.empty_like(q)
    part_ml = torch.empty(shape.part_ml, device=q.device)
    part_acc = torch.empty(shape.part_acc, device=q.device)
    lib = _build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    err = lib.decode_attention(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(lengths), ptr(out),
        ptr(part_ml), ptr(part_acc), ptr(counters), B, H, K, S, hd,
        shape.nsplit, shape.chunk, DTYPES[q.dtype], ctypes.c_void_p(stream))
    _build.check("decode_attention", err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
