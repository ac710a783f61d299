"""Paged serving steps: transformer decode and prefill chunks over a page pool.

Counterpart of ``repro/serve/paged_step.py``. Caches live in a physical
page pool (``[count, P, K, pt, hd]`` per group position,
serve/kvcache.py). A decode step, per layer,

  1. computes the new token's K/V,
  2. writes it at logical position ``lengths[b]`` of each active slot's
     page list,
  3. attends through the paged flash-decode kernel
     (kernels/paged_decode_attention.py).

A prefill chunk writes the chunk's K/V at ``[start, start+C)`` of one
sequence's pages and attends through the paged flash-prefill kernel.

Under tensor parallelism (a ``group`` of tp ranks, parallel/sharding.py)
each rank's pool holds one contiguous block of ``K/tp`` kv heads. The
QKV projections run whole from replicated weights and are then cut to
the rank's heads (:func:`tp_head_slice`); the rank writes and attends
over its own heads, and one ``all_gather`` of the heads before ``wo``
rebuilds the whole attention output, as the reference's ``shard_map``
step does. The kernels split as the unsharded call would, so the streams
are the same at any tp.

An int8 pool (``kv_dtype="int8"``, serve/kvquant.py) carries
``k_scale`` / ``v_scale`` leaves beside its pages; the steps branch on
``"k_scale" in pages`` as the reference does, write through
:func:`scatter_chunk_q` / :func:`_scatter_token_q` (monotone-max scales,
the page's rows requantized in the same step) and hand the scales to both
kernels, which dequantize inside.

Pages are written **in place** (the reference returned new arrays): every
step returns the same ``pages`` object it was given, updated. The steps
are plain functions over a
:class:`~repro_torch.models.transformer.Transformer` and run on whatever
device its tensors live on; its weights must already be at the compute
dtype (serve/executor.py casts them once). Queries enter attention in f32
and the attention output returns to the compute dtype, as in the
reference. The swap tier (serve/tiering.py) moves whole pages:
:func:`gather_pages` copies a sequence's pages out, :func:`scatter_pages`
writes them back in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode_attention import paged_flash_decode
from repro_torch.kernels.paged_prefill_attention import paged_flash_prefill
from repro_torch.models import transformer
from repro_torch.parallel import sharding
from repro_torch.serve import kvquant


def page_index(page_ids, device) -> torch.Tensor:
    """Page ids as an int64 index tensor on ``device``. On the card the ids
    travel in one non-blocking copy from pinned memory: a pageable copy
    would make the host wait for every step already queued."""
    ids = torch.tensor(list(page_ids), dtype=torch.long)
    if torch.device(device).type == "cuda":
        return ids.pin_memory().to(device, non_blocking=True)
    return ids


def gather_pages(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Pull a sequence's pages out of a ``[count, P, ...]`` pool leaf into a
    new contiguous ``[count, n, ...]`` tensor (swap-out's gather phase;
    the caller starts a dev→host copy of the result)."""
    return pool[:, page_ids]


def scatter_pages(pool: torch.Tensor, rows: torch.Tensor,
                  page_ids: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`gather_pages`: land ``[count, n, ...]`` rows on the
    given page ids of a pool leaf, in place, cast to the pool's dtype
    (swap-in's store phase). Returns ``pool``."""
    return pool.index_copy_(1, page_ids, rows.to(pool.dtype))


def copy_page(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Duplicate page ``src`` onto page ``dst`` of a ``[count, P, ...]`` pool
    leaf, in place (the copy half of copy-on-write). Returns ``pool``."""
    pool[:, dst].copy_(pool[:, src])
    return pool


def scatter_chunk(pool: torch.Tensor, rows: torch.Tensor,
                  page_table: torch.Tensor, start: int,
                  page_tokens: int) -> torch.Tensor:
    """Write a prefill chunk's K/V rows ([C, K, hd]) at logical positions
    ``[start, start+C)`` of one sequence's page list, in place, into a
    ``[P, K, pt, hd]`` layer pool. Positions are distinct, so the chunk
    lands in one indexed write. Returns ``pool``."""
    C = rows.shape[0]
    pos = start + torch.arange(C, device=pool.device)
    pids = page_table[pos // page_tokens].clamp_min(0).long()
    pool[pids, :, pos % page_tokens] = rows.to(pool.dtype)
    return pool


def _scatter_token(pool: torch.Tensor, tok: torch.Tensor,
                   page_table: torch.Tensor, lengths: torch.Tensor,
                   active: torch.Tensor, page_tokens: int) -> torch.Tensor:
    """Write tok[b] ([B, K, hd]) at logical position lengths[b] of each
    active slot's page list, in place, as one indexed write over the
    ``active`` slot indices only. An inactive slot's row would clamp to page
    0, which a live sequence may own, so it is never part of the write; the
    active slots write distinct (page, offset) pairs. Returns ``pool``."""
    pos = lengths[active].long()
    pids = page_table[active, pos // page_tokens].clamp_min(0).long()
    pool[pids, :, pos % page_tokens] = tok[active].to(pool.dtype)
    return pool


def scatter_chunk_q(pool: torch.Tensor, scale: torch.Tensor,
                    rows: torch.Tensor, page_table: torch.Tensor, start: int,
                    page_tokens: int) -> torch.Tensor:
    """Quantized counterpart of :func:`scatter_chunk`: land a prefill
    chunk's K/V rows ([C, K, hd]) in an int8 layer pool ([P, K, pt, hd])
    with per-page scales ([P, K]), both in place. For every page the chunk
    touches, ``scale' = max(scale, absmax(new rows)/127)``, the page's
    existing rows are requantized by ``scale/scale'`` and the new rows
    quantize at ``scale'`` (serve/kvquant.py). Pages the chunk does not
    touch are not read or written. Returns ``pool``.

    The chunk's positions are contiguous, so the pages it touches are the
    contiguous logical range ``lp0 .. lp1`` of the table; the per-page max
    is one exact ``scatter_reduce`` (the reference takes a one-hot segment
    max)."""
    C = rows.shape[0]
    pt = page_tokens
    dev = pool.device
    pos = start + torch.arange(C, device=dev)
    lp0, lp1 = start // pt, (start + C - 1) // pt
    rel = pos // pt - lp0                            # touched page per row
    rows_f = rows.float()                            # [C, K, hd]
    amax_c = rows_f.abs().amax(dim=-1)               # [C, K]
    amax_p = torch.zeros(lp1 - lp0 + 1, rows.shape[1], device=dev)
    amax_p.scatter_reduce_(0, rel[:, None].expand_as(amax_c), amax_c,
                           "amax")                   # [n, K]
    pid_t = page_table[lp0:lp1 + 1].clamp_min(0).long()
    s_old = scale[pid_t]                             # [n, K]
    s_new = torch.maximum(s_old, amax_p / kvquant.Q_MAX)
    pool[pid_t] = kvquant.requantize(pool[pid_t],
                                     kvquant.rescale_ratio(s_old, s_new))
    scale[pid_t] = s_new
    q_c = kvquant.quantize(rows_f[:, :, None, :], s_new[rel])[:, :, 0, :]
    pool[pid_t[rel], :, pos % pt] = q_c
    return pool


def _scatter_token_q(pool: torch.Tensor, scale: torch.Tensor,
                     tok: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor, active: torch.Tensor,
                     page_tokens: int) -> torch.Tensor:
    """Quantized counterpart of :func:`_scatter_token`: write tok[b]
    ([B, K, hd]) at logical position lengths[b] of each active slot's int8
    page, in place, widening that page's per-head scale monotonically and
    requantizing its rows in the same step. Inactive slots are not part of
    the write, so their pages and scale rows stay bit-untouched; an active
    write whose scale does not change requantizes at ratio exactly 1.0 (a
    bit-exact no-op on the rows already there). Active slots write distinct
    pages (a shared page is COW-forked before the write). Returns
    ``pool``."""
    pt = page_tokens
    pos = lengths[active].long()
    pids = page_table[active, pos // pt].clamp_min(0).long()
    tok_f = tok[active].float()                      # [n, K, hd]
    s_old = scale[pids]                              # [n, K]
    s_new = torch.maximum(s_old, tok_f.abs().amax(dim=-1) / kvquant.Q_MAX)
    pages = kvquant.requantize(pool[pids],
                               kvquant.rescale_ratio(s_old, s_new))
    pages[torch.arange(len(pids), device=pool.device), :, pos % pt] = \
        kvquant.quantize(tok_f[:, :, None, :], s_new)[:, :, 0, :]
    pool[pids] = pages
    scale[pids] = s_new
    return pool


def _write_chunk(kv, k, v, page_table, start: int, page_tokens: int):
    """One layer's chunk K/V ([C, K, hd]) into its pool views ``kv``."""
    if "k_scale" in kv:
        scatter_chunk_q(kv["k"], kv["k_scale"], k, page_table, start,
                        page_tokens)
        scatter_chunk_q(kv["v"], kv["v_scale"], v, page_table, start,
                        page_tokens)
    else:
        scatter_chunk(kv["k"], k, page_table, start, page_tokens)
        scatter_chunk(kv["v"], v, page_table, start, page_tokens)


def _write_token(kv, k, v, page_table, lengths, active, page_tokens: int):
    """One layer's decode K/V ([B, K, hd]) into its pool views ``kv``."""
    if "k_scale" in kv:
        _scatter_token_q(kv["k"], kv["k_scale"], k, page_table, lengths,
                         active, page_tokens)
        _scatter_token_q(kv["v"], kv["v_scale"], v, page_table, lengths,
                         active, page_tokens)
    else:
        _scatter_token(kv["k"], k, page_table, lengths, active, page_tokens)
        _scatter_token(kv["v"], v, page_table, lengths, active, page_tokens)


def _scales(kv):
    """The kernels' ``k_scale`` / ``v_scale`` arguments (None unless int8)."""
    return {"k_scale": kv.get("k_scale"), "v_scale": kv.get("v_scale")}


def tp_head_slice(q, k, v, kv, rank: int):
    """This rank's contiguous head block of the replicated q / k / v
    projections (axis 2): ``kv["k"]`` (a layer's ``[P, K_local, pt, hd]``
    pool view) holds the local kv-head count, and query head ``h = k·G +
    g`` follows its kv head."""
    k_local = kv["k"].shape[1]
    g = q.shape[2] // k.shape[2]
    kv0 = rank * k_local
    return (q[:, :, kv0 * g:(kv0 + k_local) * g],
            k[:, :, kv0:kv0 + k_local], v[:, :, kv0:kv0 + k_local])


def make_paged_decode_step(cfg: transformer.ModelConfig, page_tokens: int,
                           group=None):
    """Returns decode_step(model, tokens, pages, page_table, lengths, active)
    -> (logits [B, vocab], pages updated in place).

    tokens: [B, 1] int (last sampled token per slot); pages: the
    PagedCachePool.pages tree; page_table: [B, max_pages] int32; lengths:
    [B] int32 valid KV rows (the new token's write position); active: the
    decoding slots' indices, an int64 tensor (the reference took a [B] bool
    mask; indices let the KV write touch active slots only without a
    device→host read). Active slots attend over lengths+1 rows, the others
    over 0 rows. ``group``: the tp process group (None: one rank).
    """
    rank = sharding.rank_of(group)
    shards = sharding.size_of(group)

    def decode_step(model, tokens, pages, page_table, lengths, active):
        B = tokens.shape[0]
        kv_len = torch.zeros(B, dtype=torch.int32, device=tokens.device)
        kv_len[active] = lengths[active].to(torch.int32) + 1
        positions = lengths.long()[:, None]                     # [B, 1]
        x = transformer.embed(model, tokens)                    # [B, 1, d]
        for kind, p, kv in transformer.units(model, pages):
            _, ffn = transformer.parse_kind(kind)
            q, k, v = transformer.layer_pre(p, x, positions, cfg)
            if group is not None:
                q, k, v = tp_head_slice(q, k, v, kv, rank)
            _write_token(kv, k[:, 0], v[:, 0], page_table, lengths, active,
                         page_tokens)
            att = paged_flash_decode(q[:, 0].float().contiguous(), kv["k"],
                                     kv["v"], page_table, kv_len,
                                     **_scales(kv), shards=shards)
            if group is not None:
                att = sharding.all_gather_cat(att, group, dim=1)
            x = transformer.layer_post(p, x, att[:, None], ffn, cfg)
        return transformer.logits(model, x)[:, 0], pages

    return decode_step


def make_paged_prefill_chunk_step(cfg: transformer.ModelConfig,
                                  page_tokens: int, group=None):
    """Returns prefill_chunk(model, tokens, pages, page_table, start)
    -> (last_logits [1, vocab], pages updated in place).

    tokens: [1, C] int prompt slice ``prompt[start:start+C]``; page_table:
    [max_pages] int32 (the sequence's row, every prompt page reserved);
    start: host int chunk offset. Only the chunk's last position goes
    through the final norm and the LM head: the same numbers as slicing
    after the product, without a [C, vocab] product. ``group``: the tp
    process group (None: one rank).
    """
    rank = sharding.rank_of(group)
    shards = sharding.size_of(group)

    def prefill_chunk(model, tokens, pages, page_table, start):
        C = tokens.shape[1]
        positions = (start + torch.arange(C, device=tokens.device))[None]
        x = transformer.embed(model, tokens)                    # [1, C, d]
        for kind, p, kv in transformer.units(model, pages):
            _, ffn = transformer.parse_kind(kind)
            q, k, v = transformer.layer_pre(p, x, positions, cfg)
            if group is not None:
                q, k, v = tp_head_slice(q, k, v, kv, rank)
            _write_chunk(kv, k[0], v[0], page_table, start, page_tokens)
            att = paged_flash_prefill(q[0].float().contiguous(), kv["k"],
                                      kv["v"], page_table, start,
                                      **_scales(kv), shards=shards)
            if group is not None:
                att = sharding.all_gather_cat(att, group, dim=1)
            x = transformer.layer_post(p, x, att[None], ffn, cfg)
        return transformer.logits(model, x[:, -1:])[:, -1], pages

    return prefill_chunk
