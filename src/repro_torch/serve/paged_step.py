"""Paged serving steps: transformer decode and prefill chunks over a page pool.

Counterpart of ``repro/serve/paged_step.py`` at tp = 1 on compute-dtype
pages. Caches live in a physical page pool (``[count, P, K, pt, hd]`` per
group position, serve/kvcache.py). A decode step, per layer,

  1. computes the new token's K/V,
  2. writes it at logical position ``lengths[b]`` of each active slot's
     page list,
  3. attends through the paged flash-decode kernel
     (kernels/paged_decode_attention.py).

A prefill chunk writes the chunk's K/V at ``[start, start+C)`` of one
sequence's pages and attends through the paged flash-prefill kernel.

Pages are written **in place** (the reference returned new arrays): every
step returns the same ``pages`` object it was given, updated. The steps are
plain functions over a :class:`~repro_torch.models.transformer.Transformer`
and run on whatever device its tensors live on; its weights must already
be at the compute dtype (serve/executor.py casts them once). Queries enter
attention in f32 and the attention output returns to the compute dtype, as
in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_decode_attention import paged_flash_decode
from repro_torch.kernels.paged_prefill_attention import paged_flash_prefill
from repro_torch.models import blocks, transformer


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


def _layer_pre(p, x, positions, cfg: transformer.ModelConfig):
    """Norm, QKV projections with bias, RoPE: x [B, L, d] → q [B, L, H, hd],
    k, v [B, L, K, hd]."""
    B, L, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    m = p["mixer"]
    h = transformer._norm_apply(p["ln1"], x, cfg)
    q, k, v = h @ m["wq"], h @ m["wk"], h @ m["wv"]
    if cfg.qkv_bias:
        q, k, v = q + m["bq"], k + m["bk"], v + m["bv"]
    q = q.reshape(B, L, H, hd)
    k = k.reshape(B, L, K, hd)
    v = v.reshape(B, L, K, hd)
    if cfg.rope_theta is not None:
        q = blocks.apply_rope(q, positions, cfg.rope_theta)
        k = blocks.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _layer_post(p, x, att, ffn: str, cfg: transformer.ModelConfig):
    """Output projection, residual, MLP: att [B, L, H, hd] f32."""
    B, L = x.shape[:2]
    x = x + att.reshape(B, L, -1).to(x.dtype) @ p["mixer"]["wo"]
    if ffn != "none":
        h2 = transformer._norm_apply(p["ln2"], x, cfg)
        x = x + transformer._ffn_apply(p["ffn"], ffn, h2, cfg)
    return x


def _units(model: transformer.Transformer, pages):
    """Walk every layer in order: (kind, layer weights, that layer's
    {"k", "v"} [P, K, pt, hd] pool views)."""
    for gi, (pattern, count) in enumerate(model.cfg.groups):
        for u in range(count):
            for i, kind in enumerate(pattern):
                kv = pages[gi][i]
                yield (kind, model.groups[gi][i].unit(u), kv["k"][u],
                       kv["v"][u])


def _embed(model: transformer.Transformer, tokens):
    x = blocks.embed_lookup(model.embed, tokens)
    if model.cfg.embed_scale:
        x = x * math.sqrt(model.cfg.d_model)
    return x


def _logits(model: transformer.Transformer, x):
    h = transformer._norm_apply({"scale": model.final_norm}, x, model.cfg)
    return h @ model.head()


def make_paged_decode_step(cfg: transformer.ModelConfig, page_tokens: int):
    """Returns decode_step(model, tokens, pages, page_table, lengths, active)
    -> (logits [B, vocab], pages updated in place).

    tokens: [B, 1] int (last sampled token per slot); pages: the
    PagedCachePool.pages tree; page_table: [B, max_pages] int32; lengths:
    [B] int32 valid KV rows (the new token's write position); active: the
    decoding slots' indices, an int64 tensor (the reference took a [B] bool
    mask; indices let the KV write touch active slots only without a
    device→host read). Active slots attend over lengths+1 rows, the others
    over 0 rows.
    """

    def decode_step(model, tokens, pages, page_table, lengths, active):
        B = tokens.shape[0]
        kv_len = torch.zeros(B, dtype=torch.int32, device=tokens.device)
        kv_len[active] = lengths[active].to(torch.int32) + 1
        positions = lengths.long()[:, None]                     # [B, 1]
        x = _embed(model, tokens)                               # [B, 1, d]
        for kind, p, k_pool, v_pool in _units(model, pages):
            _, ffn = transformer.parse_kind(kind)
            q, k, v = _layer_pre(p, x, positions, cfg)
            _scatter_token(k_pool, k[:, 0], page_table, lengths, active,
                           page_tokens)
            _scatter_token(v_pool, v[:, 0], page_table, lengths, active,
                           page_tokens)
            att = paged_flash_decode(q[:, 0].float().contiguous(), k_pool,
                                     v_pool, page_table, kv_len)
            x = _layer_post(p, x, att[:, None], ffn, cfg)
        return _logits(model, x)[:, 0], pages

    return decode_step


def make_paged_prefill_chunk_step(cfg: transformer.ModelConfig,
                                  page_tokens: int):
    """Returns prefill_chunk(model, tokens, pages, page_table, start)
    -> (last_logits [1, vocab], pages updated in place).

    tokens: [1, C] int prompt slice ``prompt[start:start+C]``; page_table:
    [max_pages] int32 (the sequence's row, every prompt page reserved);
    start: host int chunk offset. Only the chunk's last position goes
    through the final norm and the LM head: the same numbers as slicing
    after the product, without a [C, vocab] product.
    """

    def prefill_chunk(model, tokens, pages, page_table, start):
        C = tokens.shape[1]
        positions = (start + torch.arange(C, device=tokens.device))[None]
        x = _embed(model, tokens)                               # [1, C, d]
        for kind, p, k_pool, v_pool in _units(model, pages):
            _, ffn = transformer.parse_kind(kind)
            q, k, v = _layer_pre(p, x, positions, cfg)
            scatter_chunk(k_pool, k[0], page_table, start, page_tokens)
            scatter_chunk(v_pool, v[0], page_table, start, page_tokens)
            att = paged_flash_prefill(q[0].float().contiguous(), k_pool,
                                      v_pool, page_table, start)
            x = _layer_post(p, x, att[None], ffn, cfg)
        return _logits(model, x[:, -1:])[:, -1], pages

    return prefill_chunk
