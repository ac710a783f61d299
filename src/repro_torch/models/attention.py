"""Grouped-query attention over a dense slot cache: the dense serving path.

Counterpart of the serving half of ``repro/models/attention.py``
(``gqa_forward`` with a cache, ``attention.py:120``): QKV projections with
bias, RoPE, the new K/V written into a ``[B, K, S, hd]`` slot cache, the
attention, and the output projection. Query head ``h = k·G + g`` attends kv
head ``k`` (G = H/K).

Two cases, each on a hand-written kernel on the card and on its plain
PyTorch version on the CPU (the wrappers dispatch by the tensors' device;
nothing here does):

  * **decode** (one token a slot): slot b writes at its own position
    ``cache_pos[b]``, rotates its query at that position and attends the
    first ``cache_pos[b] + 1`` rows of its cache through
    :func:`~repro_torch.kernels.decode_attention.flash_decode`. The
    reference runs every slot at one shared position, the largest length
    less one (``repro/serve/scheduler.py:466-469``), so a slot shorter than
    the longest attends empty rows and rotates at the wrong position; the
    port keeps each slot at its own length, and its streams equal the
    reference's paged engine's (tests/test_torch_dense.py pins the
    difference).
  * **prefill** from position 0: the L new keys, causal, through
    :func:`~repro_torch.kernels.flash_attention.flash_attention` (kv heads
    repeated to the query heads), after the K/V land in cache rows
    ``[0, L)``. The reference attends the cache masked to its first L rows,
    which are these keys.

A sliding-window layer (``window``: gemma3's ``local`` layers) keeps a
**ring** of ``W = min(max_seq, window)`` rows a slot, position p in row
``p % W`` (the reference's ``_ring_update``). Prefill attends the L new
keys through ``flash_attention(..., window=window)``, masked by position
(``kpos > qpos - window``) as the reference's no-cache forward is, then
writes only the last ``min(L, W)`` keys into the ring, each row once.
The reference scatters all L keys into the W rows, so for L > W rows
collide, and it attends the ring as if row i held position i: its dense
engine parts from its own forward on a prompt past the window
(tests/test_torch_gemma3.py pins it); for L ≤ W the rows are the same.
A decode step writes row ``cache_pos[b] % W`` and attends
``min(cache_pos[b] + 1, W)`` rows: the softmax does not care in which
order the ring holds them.

**Cross-attention** (:func:`cross_forward`: llama-3.2-vision-11b's image
layers, whisper's decoder; ref ``cross_forward``, ``attention.py:214``)
projects ``wq`` / ``wk`` / ``wv`` / ``wo`` with no bias whatever
``cfg.qkv_bias`` says (the reference's ``init_cross`` makes none) and no
RoPE. At prefill the K/V of the encoder states ``extra`` [B, S_enc, kv_dim]
are projected once, written into the layer's cross cache [B, K, S_enc, hd]
at its dtype, and the L queries attend the un-cast K/V through
``flash_attention(causal=False)`` (Lq ≠ Lk, kv heads repeated); a decode
step reads the cache through ``flash_decode`` with every slot's length
S_enc and never projects again. The **encoder's** ``enc`` layers
(:func:`encoder_forward`, whisper) attend their S_enc frames with no
cache: QKV with bias, then ``flash_attention(causal=False)``.

**MLA** (:func:`mla_forward`: deepseek-v3's multi-head latent attention;
ref ``mla_forward``, ``attention.py:275``) caches one latent ``ckv``
[B, S, kv_lora] and one rotary key ``kr`` [B, S, qk_rope] a token, shared
by every head, and attends in the latent space in the reference's
absorbed form, its einsums in f32: ``q_lat = q_nope · w_uk``, logits
``(q_lat · ckv + q_rope · kr) / sqrt(qk_nope + qk_rope)``, masked at
-1e30, then ``(softmax · ckv) · w_uv`` cast back, then ``wo``. The cache
is read through the cast to the input's dtype, as the reference reads it.
The same two cases as GQA: a decode step writes slot b's latent at its
own ``cache_pos[b]`` and attends its first ``cache_pos[b] + 1`` rows (the
reference's cached MLA takes one shared position, its dense engine's
fault again); a prefill from position 0 lands the L latents in rows
``[0, L)`` and attends them causally, ``MLA_Q_BLOCK`` query rows at a
time (at full width the logits of 8 coupled rows of 1536 tokens would
be 9.7 GB of f32 at once). It calls no hand-written kernel: the
reference computes it in plain ``jnp`` and reaches no ``pallas_call``.

**On one rank of a mesh** (:func:`gqa_forward`, :func:`cross_forward`,
:func:`encoder_forward` and :func:`mla_forward` with their leaves' and
cache's specs: the serving steps on a rank's shards, models/transformer.py
``hidden``) the same cases run on the rank's columns of the projections,
its kv heads and its rows of the cache, each read from the leaf's spec:
the heads are attended locally where the columns fall on head boundaries
and gathered over the model line first where they do not; a cache cut
over its rows (``kv_seq``) writes each decode position on the rank that
holds it, and the attention over each rank's rows
(``flash_decode(..., return_lse=True)``, or MLA's absorbed attention with
its lse) is merged by ``sharding.combine_partials``; ``wo``'s rows give a
partial product summed over the line.

**No cache: the training forward.** Every attention layer that runs with
no cache goes through :func:`~repro_torch.models.flash_xla.
flash_attention_xla` (plain PyTorch with its own backward, as the
reference's ``_attend_streaming`` goes through its plain-XLA
``flash_attention_xla``), never through the serving kernels:
:func:`gqa_forward` with ``cache=None`` (causal, a ``local`` layer's
window; an encoder's ``enc`` layer with ``causal=False``),
:func:`cross_forward` with ``cache=None`` (K/V from the
encoder states, non-causal, every key valid) and :func:`mla_forward`
with ``cache=None`` (K and V expanded from the latent, ``ckv @ w_uk`` and
``ckv @ w_uv``, the rotary key broadcast to every head: head dim qk_nope
+ qk_rope, V zero-padded to it and sliced back after).

A config's ``logit_softcap`` c caps every scaled logit s as tanh(s / c)·c
before the mask, as the reference's ``_decode_attend`` and
``_attend_streaming`` do: both kernels take it (``flash_decode(...,
softcap=c)`` with its lse over the capped logits, so the SP combine
holds; ``flash_attention(..., softcap=c)``), and so does the training
attention. Only the paged pools refuse a softcap (serve/kvcache.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import blocks
from repro_torch.models.flash_xla import flash_attention_xla
from repro_torch.parallel import sharding


def qkv(m: Dict[str, torch.Tensor], h: torch.Tensor, positions: torch.Tensor,
        cfg, q_cols=None, kv_cols=None, apart: bool = False):
    """QKV projections with bias and RoPE: h [B, L, d] (already normed),
    positions [B, L] absolute → q [B, L, H, hd], k, v [B, L, K, hd].
    ``q_cols`` / ``kv_cols``: ``(part, lo, hi)``, keep only the columns
    [lo, hi) of the whole projection, of which ``m`` holds ``part``
    (``sharding.take``, ``apart`` as its): q then holds (hi − lo) / hd
    heads."""
    B, L, _ = h.shape
    hd = cfg.hd
    q, k, v = h @ m["wq"], h @ m["wk"], h @ m["wv"]
    if cfg.qkv_bias:
        q, k, v = q + m["bq"], k + m["bk"], v + m["bv"]
    if q_cols is not None:
        q = sharding.take(q, q_cols[0], q_cols[1:], apart=apart)[0]
    if kv_cols is not None:
        k, v = (sharding.take(a, kv_cols[0], kv_cols[1:], apart=apart)[0]
                for a in (k, v))
    q = q.reshape(B, L, -1, hd)
    k = k.reshape(B, L, -1, hd)
    v = v.reshape(B, L, -1, hd)
    if cfg.rope_theta is not None:
        q = blocks.apply_rope(q, positions, cfg.rope_theta)
        k = blocks.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def ring_write(cache: torch.Tensor, new: torch.Tensor, W: Optional[int] = None,
               lo: int = 0) -> None:
    """Land a prefill's L keys ``new`` [B, K, L, hd] (positions 0..L-1)
    in a ring of ``W`` rows (default: ``cache``'s) of which ``cache`` [B,
    K, R, hd] holds the rows ``[lo, lo + R)``, in place: only the last
    ``min(L, W)`` positions, position p in ring row ``p % W``, so no row is
    written twice, and of those only the positions whose row falls in
    ``cache`` (a ring cut over its rows: ``kv_seq``). At most two slice
    copies, from host ints only."""
    R, L = cache.shape[2], new.shape[2]
    W = R if W is None else W
    n = min(L, W)
    first = L - n
    r0 = first % W
    head = min(n, W - r0)
    # (ring rows [a, b), the position in row a): the run to the ring's
    # end, then the rest wrapped to row 0
    for a, b, p in ((r0, r0 + head, first), (0, n - head, first + head)):
        a_, b_ = max(a, lo), min(b, lo + R)
        if b_ > a_:
            cache[:, :, a_ - lo:b_ - lo] = \
                new[:, :, p + a_ - a:p + b_ - a].to(cache.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, G: int,
           causal: bool, window: Optional[int] = None,
           kv: Optional[torch.Tensor] = None,
           softcap: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` of q [B, L, H, hd] over k, v [B, K, S, hd], kv
    heads repeated to the query heads → [B, L, H, hd]: ``kv`` gives each
    query head's kv head (an index into k's heads), by default G
    consecutive query heads a kv head; ``softcap`` as the config's."""
    if kv is None:
        kv = torch.arange(q.shape[2], device=q.device) // G
    return flash_attention(
        q.transpose(1, 2).contiguous(), k.index_select(1, kv),
        v.index_select(1, kv), causal=causal, window=window,
        softcap=softcap).transpose(1, 2)


def attend_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                 causal: bool, window: Optional[int] = None,
                 kv_len_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The no-cache attention (the reference's ``_attend_streaming``): q
    [B, L, H, hd] over k, v [B, S, K, hd] through ``flash_attention_xla``
    with ``cfg``'s chunks and softcap (an :class:`MlaConfig` has none) →
    [B, L, H, hd]."""
    return flash_attention_xla(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
        window, getattr(cfg, "logit_softcap", None), cfg.q_chunk,
        cfg.kv_chunk, 0, kv_len_mask).transpose(1, 2)


def gqa_forward(m: Dict[str, torch.Tensor], h: torch.Tensor,
                positions: torch.Tensor, cfg,
                cache: Optional[Dict[str, torch.Tensor]], cache_pos,
                window: Optional[int] = None, causal: bool = True,
                spec: Optional[Dict[str, Tuple]] = None,
                cache_spec: Optional[Dict[str, Tuple]] = None
                ) -> torch.Tensor:
    """One layer's attention over its slot cache; returns y [B, L, d].

    h: [B, L, d] normed input; positions: [B, L] absolute; cache: ``{"k",
    "v"}`` [B, K, S, hd], written in place. ``cache_pos`` selects the
    case: a [B] int tensor is a decode step (L = 1, slot b writes at
    ``cache_pos[b]`` and attends ``cache_pos[b] + 1`` rows); the int 0 is a
    prefill of every slot from position 0. ``window``: the layer's
    sliding window (``cfg.window_of(mixer)``); its cache is then a ring of
    S ≤ window rows (see the module docstring). With ``cache=None`` the
    training forward: the L keys attended through
    :func:`attend_train` (``causal``, ``window``), ``cache_pos`` unused.

    On one rank of the active mesh, ``m`` holds the rank's shards of the
    leaves and ``cache`` its part of the slot cache, under ``spec`` /
    ``cache_spec`` (their ``parallel/sharding.resolve`` specs, the batch
    axes already gathered or the rank's rows); ``h`` is the rank's rows,
    whole across the model line, and so is y. Every step reads its leaf's
    spec (``sharding.held``: with no spec, the whole dimension), whatever
    the arch and however the split falls. The training forward
    (``cache=None``) attends the heads ``wo``'s rows take over their kv
    heads (:func:`attend_train`), under autograd: ``h`` enters through
    ``copy_to`` over ``wo``'s line, a leaf whole on that line through
    ``copy_to`` too (each rank uses its own columns of it), and
    projections gathered off a head's boundary through ``take(...,
    apart=True)`` (parallel/sharding.py's module docstring). In the
    serving cases:

      * the heads attended: in a decode step every query head of the kv
        heads the cache holds (the same on every rank of a line that cuts
        the cache's rows); in a prefill those whose columns ``wo``'s rows
        take, each over its own kv head;
      * q / k / v: the rank's columns of ``wq`` / ``wk`` / ``wv`` (and
        biases), used as they are when they hold those heads' columns (a
        split on head boundaries), else all-gathered over the line first;
      * the cache: only the kv heads and rows it holds are written; a
        decode position p lands at p − lo on the rank whose rows [lo, hi)
        hold it; a ring (window) layer's position p lands in ring row p %
        W, on the rank that holds that row (``ring_write`` of the rank's
        rows at prefill);
      * decode: ``flash_decode`` over the held rows, at lengths clamp(len
        − lo, 0, hi − lo) (a ring's len: min(len, W)), an empty slice's
        lse weighing nothing; with the rows cut, with ``return_lse`` and
        ``combine_partials`` over their line; prefill: ``flash_attention``
        on the heads' L new keys;
      * output: the rank's columns of the attention output times its rows
        of ``wo``, summed over ``wo``'s line (``reduce_from``)."""
    B, L, _ = h.shape
    mesh = sharding.current_mesh()
    spec, cache_spec = spec or {}, cache_spec or {}
    G, hd = cfg.n_heads // cfg.n_kv, cfg.hd
    qc = sharding.held(m["wq"], spec.get("wq"), 1, mesh)
    kvc = sharding.held(m["wk"], spec.get("wk"), 1, mesh)
    oc = sharding.held(m["wo"], spec.get("wo"), 0, mesh)
    if cache is None:
        h_lo, h_hi, w_lo, w_hi = _head_plan(cfg, oc, None, False)
        m, h_in = _train_entry(m, h, spec, mesh, oc, (qc, kvc), cfg.name)
        q, k, v = qkv(m, h_in, positions, cfg, (qc, h_lo * hd, h_hi * hd),
                      (kvc, w_lo * hd, w_hi * hd), apart=oc.line is not None)
        if (h_lo, h_hi) != (w_lo * G, w_hi * G):   # not whole groups
            kv = _kv_index(h_lo, h_hi, G, w_lo, h.device)
            k, v = k.index_select(2, kv), v.index_select(2, kv)
        att = attend_train(q, k, v, cfg, causal, window)
        return _out(att, m["wo"], oc, h_lo * hd, h.dtype)
    kc, vc = cache["k"], cache["v"]
    heads = sharding.held(kc, cache_spec.get("k"), 1, mesh)
    rows = sharding.held(kc, cache_spec.get("k"), 2, mesh)
    S_loc, S = kc.shape[2], rows.whole
    decode = isinstance(cache_pos, torch.Tensor)
    if not decode and cache_pos != 0:
        raise ValueError(f"gqa_forward: cache_pos must be a [B] tensor "
                         f"(decode) or 0 (prefill), got {cache_pos!r}")
    if decode and L != 1:
        raise ValueError(f"gqa_forward: a decode step takes one token a "
                         f"slot, got L={L}")
    if window is not None and S > window:
        raise ValueError(f"gqa_forward: a window-{window} layer keeps a ring "
                         f"of at most {window} rows, got {S}")
    if not decode and window is None and L > S:
        raise ValueError(f"gqa_forward: a prefill of {L} tokens into a "
                         f"cache of {S} rows")
    h_lo, h_hi, w_lo, w_hi = _head_plan(cfg, oc, heads, decode)
    q, k, v = qkv(m, h, positions, cfg, (qc, h_lo * hd, h_hi * hd),
                  (kvc, w_lo * hd, w_hi * hd))
    mine = slice(heads.lo - w_lo, heads.hi - w_lo)      # the cache's heads
    if decode:
        pos = cache_pos.long()
        lengths = cache_pos + 1
        if window is not None:
            pos, lengths = pos % S, lengths.clamp(max=S)
        for c, new in ((kc, k), (vc, v)):
            _write_position(c, new[:, 0, mine], pos, rows, 2)
        lengths = (lengths - rows.lo).clamp(0, S_loc).to(torch.int32)
        att = _decode_attend(q[:, 0].contiguous(), kc, vc, lengths,
                             rows, cfg.logit_softcap)[:, None]
    else:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)     # [B, Kw, L, hd]
        if window is None:
            r0, r1 = rows.lo, min(rows.hi, L)
            if r1 > r0:
                kc[:, :, :r1 - r0] = kt[:, mine, r0:r1].to(kc.dtype)
                vc[:, :, :r1 - r0] = vt[:, mine, r0:r1].to(vc.dtype)
        else:
            ring_write(kc, kt[:, mine], S, rows.lo)
            ring_write(vc, vt[:, mine], S, rows.lo)
        att = attend(q, kt, vt, G, causal=True, window=window,
                     kv=_kv_index(h_lo, h_hi, G, w_lo, h.device),
                     softcap=cfg.logit_softcap)
    return _out(att, m["wo"], oc, h_lo * hd, h.dtype)


def _train_entry(m: Dict[str, torch.Tensor], h: torch.Tensor, spec, mesh,
                 oc: sharding.Held, parts, name: str):
    """(m, h) for the training forward on a rank's shards: with the heads
    split over ``wo``'s line, ``h`` through ``copy_to`` over it and each
    leaf but ``wo`` (projections, biases, MLA's down-projections and
    norms) that is whole on it through ``copy_to`` as well, since a rank
    uses only its heads' part of what it feeds. With ``wo`` whole every
    rank attends every head alike, and a projection cut over a line
    (``parts``: the column cuts of the heads' projections) would then be
    a mix this path does not take; ``name`` names the layer's arch."""
    if oc.line is None:
        if any(part.line is not None for part in parts):
            raise NotImplementedError(
                f"{name}: the heads' projection columns cut over a line "
                "while wo's rows are whole (a heads_tp / kv_heads_tp rule "
                "split): no training path")
        return m, h
    m = dict(m)
    for leaf, t in m.items():
        if leaf == "wo":
            continue
        part = sharding.held(t, spec.get(leaf), t.dim() - 1, mesh)
        if part.line is None:
            m[leaf] = sharding.copy_to(t, oc.line)
        elif part.line.axes != oc.line.axes:
            raise NotImplementedError(
                f"{name}: {leaf} cut over {part.line.axes}, wo's rows "
                f"over {oc.line.axes}: no training path")
    return m, sharding.copy_to(h, oc.line)


def _head_plan(cfg, oc: sharding.Held, heads: Optional[sharding.Held],
               decode: bool) -> Tuple[int, int, int, int]:
    """The query heads ``[h_lo, h_hi)`` a rank attends and the kv heads
    ``[w_lo, w_hi)`` it projects (see :func:`gqa_forward`): in a decode
    step every query head of the kv heads its cache holds (``heads``),
    else those whose columns ``wo``'s rows ``oc`` take, each group's kv
    head, and the cache's kv heads beside them (``heads`` None: no
    cache)."""
    G, hd = cfg.n_heads // cfg.n_kv, cfg.hd
    if decode:
        k_lo, k_hi = heads.lo, heads.hi
        h_lo, h_hi = k_lo * G, k_hi * G
    else:
        h_lo, h_hi = oc.lo // hd, -(-oc.hi // hd)
        k_lo, k_hi = h_lo // G, -(-h_hi // G)
    if not (h_lo * hd <= oc.lo and oc.hi <= h_hi * hd):
        raise NotImplementedError(
            f"{cfg.name}: wo's rows [{oc.lo}, {oc.hi}) need heads outside "
            f"the kv heads [{k_lo}, {k_hi}) of the rank's cache")
    if heads is None:
        return h_lo, h_hi, k_lo, k_hi
    return h_lo, h_hi, min(k_lo, heads.lo), max(k_hi, heads.hi)


def _kv_index(h_lo: int, h_hi: int, G: int, w_lo: int, device
              ) -> torch.Tensor:
    """Each query head of ``[h_lo, h_hi)``'s kv head, an index into the
    projected kv heads from ``w_lo`` (the heads need not fill whole
    groups)."""
    return torch.arange(h_lo, h_hi, device=device) // G - w_lo


def _write_position(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                    rows: sharding.Held, axis: int) -> None:
    """A decode step's ``new`` [B, ...] into ``c`` at each slot's position
    ``pos`` [B] on the sequence axis ``axis`` of c (1 or 2), in place.
    With the rows cut (``rows``: this rank's [lo, hi)), a position p lands
    at p − lo on the rank that holds it; a slot whose position another
    rank holds keeps its row as it is."""
    new = new.to(c.dtype)
    slots = torch.arange(c.shape[0], device=c.device)
    at = (slots, slice(None), pos) if axis == 2 else (slots, pos)
    if rows.line is not None:
        row = (pos - rows.lo).clamp(0, c.shape[axis] - 1)
        at = (slots, slice(None), row) if axis == 2 else (slots, row)
        here = (pos >= rows.lo) & (pos < rows.hi)
        new = torch.where(here.view((-1,) + (1,) * (new.dim() - 1)), new,
                          c[at])
    c[at] = new


def _decode_attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   lengths: torch.Tensor, rows: sharding.Held,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """``flash_decode`` over the cache rows this rank holds, at its local
    ``lengths``, logits capped by ``softcap``; with the rows cut, with
    ``return_lse`` and ``combine_partials`` over their line."""
    if rows.line is None:
        return flash_decode(q, kc, vc, lengths, softcap=softcap)
    return sharding.combine_partials(
        *flash_decode(q, kc, vc, lengths, return_lse=True, softcap=softcap),
        rows.line)


def _out(att: torch.Tensor, wo: torch.Tensor, oc: sharding.Held, lo: int,
         dtype) -> torch.Tensor:
    """The output projection: the columns of the attention output ``att``
    [B, L, heads, ·] (its first column at ``lo`` of the whole) that
    ``wo``'s rows ``oc`` take, times them, summed over their line."""
    B, L = att.shape[:2]
    att = att.reshape(B, L, -1)[..., oc.lo - lo:oc.hi - lo]
    y = att.to(dtype) @ wo
    return y if oc.line is None else sharding.reduce_from(y, oc.line)


def cross_forward(m: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                  cache: Optional[Dict[str, torch.Tensor]],
                  extra: Optional[torch.Tensor] = None,
                  spec: Optional[Dict[str, Tuple]] = None,
                  cache_spec: Optional[Dict[str, Tuple]] = None
                  ) -> torch.Tensor:
    """One cross-attention layer; returns y [B, L, d].

    h: [B, L, d] normed input; cache: ``{"k", "v"}`` [B, K, S_enc, hd].
    With ``extra`` (the encoder states [B, S_enc, kv_dim], at h's dtype) a
    prefill: K/V projected from it land in ``cache`` (in place, at the
    cache's dtype) and the queries attend them un-cast. Without, a decode
    step (L = 1) over the cache as it stands. With ``cache=None`` the
    training forward: K/V from ``extra``, non-causal, every key valid
    (:func:`attend_train` with an all-true ``kv_len_mask``).

    On one rank of a mesh, ``spec`` / ``cache_spec`` as in
    :func:`gqa_forward`, whose head split this layer takes (the
    reference's cross projections carry the GQA layer's axes): a prefill
    projects K/V of the kv heads its queries and its cache need over every
    encoder row, writes its cache's heads and rows, and attends the heads
    ``wo``'s rows take; a decode step attends every query head of its
    cache's kv heads over the rows it holds (all S_enc rows are valid),
    merged over their line with ``combine_partials`` where they are cut.
    The training forward attends the heads ``wo``'s rows take, as
    :func:`gqa_forward`'s does, ``extra`` entering through ``copy_to``
    over ``wo``'s line beside ``h`` (every cross layer of every rank reads
    it, and uses its own kv heads' part)."""
    B, L, _ = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    mesh = sharding.current_mesh()
    spec, cache_spec = spec or {}, cache_spec or {}
    qc = sharding.held(m["wq"], spec.get("wq"), 1, mesh)
    kvc = sharding.held(m["wk"], spec.get("wk"), 1, mesh)
    oc = sharding.held(m["wo"], spec.get("wo"), 0, mesh)
    if cache is None:
        h_lo, h_hi, w_lo, w_hi = _head_plan(cfg, oc, None, False)
        m, h_in = _train_entry(m, h, spec, mesh, oc, (qc, kvc), cfg.name)
        apart = oc.line is not None
        if apart:
            extra = sharding.copy_to(extra, oc.line)
        S = extra.shape[1]
        q = sharding.take(h_in @ m["wq"], qc, (h_lo * hd, h_hi * hd),
                          apart=apart)[0].reshape(B, L, -1, hd)
        k, v = (sharding.take(extra @ m[w], kvc, (w_lo * hd, w_hi * hd),
                              apart=apart)[0].reshape(B, S, -1, hd)
                for w in ("wk", "wv"))
        if (h_lo, h_hi) != (w_lo * (H // K), w_hi * (H // K)):
            kv = _kv_index(h_lo, h_hi, H // K, w_lo, h.device)
            k, v = k.index_select(2, kv), v.index_select(2, kv)
        valid = torch.ones(B, S, dtype=torch.bool, device=h.device)
        att = attend_train(q, k, v, cfg, False, kv_len_mask=valid)
        return _out(att, m["wo"], oc, h_lo * hd, h.dtype)
    kc, vc = cache["k"], cache["v"]
    heads = sharding.held(kc, cache_spec.get("k"), 1, mesh)
    rows = sharding.held(kc, cache_spec.get("k"), 2, mesh)
    S = rows.whole
    decode = extra is None
    if decode and L != 1:
        raise ValueError(f"cross_forward: a prefill of {L} tokens needs the "
                         "encoder states (extra)")
    h_lo, h_hi, w_lo, w_hi = _head_plan(cfg, oc, heads, decode)
    q = sharding.take(h @ m["wq"], qc, (h_lo * hd, h_hi * hd))[0].reshape(
        B, L, -1, hd)
    if decode:
        lengths = torch.full((B,), kc.shape[2], dtype=torch.int32,
                             device=h.device)
        att = _decode_attend(q[:, 0].contiguous(), kc.to(q.dtype),
                             vc.to(q.dtype), lengths, rows,
                             cfg.logit_softcap)[:, None]
    else:
        if tuple(extra.shape[:2]) != (B, S):
            raise ValueError(f"cross_forward: encoder states "
                             f"{tuple(extra.shape)} do not fill a cross "
                             f"cache of {S} rows for {B} slots")
        k, v = (sharding.take(extra @ m[w], kvc, (w_lo * hd, w_hi * hd))[0]
                .reshape(B, S, -1, hd).transpose(1, 2) for w in ("wk", "wv"))
        mine = slice(heads.lo - w_lo, heads.hi - w_lo)
        kc.copy_(k[:, mine, rows.lo:rows.hi])
        vc.copy_(v[:, mine, rows.lo:rows.hi])
        att = attend(q, k, v, H // K, causal=False,
                     kv=_kv_index(h_lo, h_hi, H // K, w_lo, h.device),
                     softcap=cfg.logit_softcap)
    return _out(att, m["wo"], oc, h_lo * hd, h.dtype)


def encoder_forward(m: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                    spec: Optional[Dict[str, Tuple]] = None) -> torch.Tensor:
    """One encoder (``enc``) layer's attention, no cache: h [B, S, d]
    normed → y [B, S, d], every frame attending every frame. On one rank
    of a mesh (``spec`` as in :func:`gqa_forward`) the heads ``wo``'s rows
    take, as a prefill there."""
    B, S, _ = h.shape
    mesh, spec = sharding.current_mesh(), spec or {}
    qc = sharding.held(m["wq"], spec.get("wq"), 1, mesh)
    kvc = sharding.held(m["wk"], spec.get("wk"), 1, mesh)
    oc = sharding.held(m["wo"], spec.get("wo"), 0, mesh)
    h_lo, h_hi, w_lo, w_hi = _head_plan(cfg, oc, None, False)
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    q, k, v = qkv(m, h, positions, cfg, (qc, cfg.hd * h_lo, cfg.hd * h_hi),
                  (kvc, cfg.hd * w_lo, cfg.hd * w_hi))
    G = cfg.n_heads // cfg.n_kv
    att = attend(q, k.transpose(1, 2), v.transpose(1, 2), G, causal=False,
                 kv=_kv_index(h_lo, h_hi, G, w_lo, h.device),
                 softcap=cfg.logit_softcap)
    return _out(att, m["wo"], oc, h_lo * cfg.hd, h.dtype)


# --------------------------------------------------------------------------
# MLA: multi-head latent attention (deepseek-v3)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MlaConfig:
    """The reference's ``MlaConfig``, every field (``q_chunk`` /
    ``kv_chunk`` drive only its no-cache streaming path)."""
    d_model: int = 7168
    n_heads: int = 128
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0
    q_chunk: int = 1024
    kv_chunk: int = 1024


MLA_Q_BLOCK = 256    # query rows a block of an MLA prefill's attention


def mla_leaves(cfg: MlaConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                  Optional[float]]]:
    """The reference's ``init_mla`` leaves: name → (shape, std), std None
    for a norm scale of ones. ``dense_init`` draws N(0, 1/fan_in), ``wo``
    N(0, 1/(H·v_dim))."""
    d, H = cfg.d_model, cfg.n_heads
    shapes = {"w_dq": (d, cfg.q_lora), "q_norm": (cfg.q_lora,),
              "w_uq": (cfg.q_lora, H * (cfg.qk_nope + cfg.qk_rope)),
              "w_dkv": (d, cfg.kv_lora), "kv_norm": (cfg.kv_lora,),
              "w_kr": (d, cfg.qk_rope),
              "w_uk": (cfg.kv_lora, H * cfg.qk_nope),
              "w_uv": (cfg.kv_lora, H * cfg.v_dim),
              "wo": (H * cfg.v_dim, d)}
    return {name: (shape, None if name.endswith("_norm")
                   else 1 / math.sqrt(shape[0]))
            for name, shape in shapes.items()}


# each MLA leaf's logical sharding axes (the reference's ``init_mla``)
MLA_AXES = {"w_dq": ("embed_fsdp", None), "q_norm": (None,),
            "w_uq": (None, "heads_tp"), "w_dkv": ("embed_fsdp", None),
            "kv_norm": (None,), "w_kr": ("embed_fsdp", None),
            "w_uk": (None, "heads_tp"), "w_uv": (None, "heads_tp"),
            "wo": ("heads_tp", "embed_fsdp")}


def _mla_attend(q_nope, q_rope, ckv, kr, mask, w_uk, w_uv,
                cfg: MlaConfig, return_lse: bool = False):
    """The reference's ``_mla_absorbed_attend``: q_nope [B, L, H, nope],
    q_rope [B, L, H, rope] over the latents ckv [B, S, c] and kr [B, S,
    rope], ``mask`` broadcasting to [B, H, L, S] (True: attended), w_uk
    [c, H, nope] and w_uv [c, H, v] in f32 → out [B, L, H, v] f32; with
    ``return_lse`` also lse [B, L, H] f32, the log of each softmax's
    denominator over these keys (for ``sharding.combine_partials``: a row
    with none visible has lse -1e30 + log S, which is -1e30, and the mean
    of the values)."""
    ckv32 = ckv.float()
    q_lat = torch.einsum("blhn,chn->blhc", q_nope.float(), w_uk)
    logits = torch.einsum("blhc,bsc->bhls", q_lat, ckv32)
    logits += torch.einsum("blhr,bsr->bhls", q_rope.float(), kr.float())
    logits /= math.sqrt(cfg.qk_nope + cfg.qk_rope)
    logits.masked_fill_(~mask, -1e30)
    pr = torch.softmax(logits, dim=-1)
    lat = torch.einsum("bhls,bsc->blhc", pr, ckv32)
    out = torch.einsum("blhc,chv->blhv", lat, w_uv)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).transpose(1, 2)
    return out


def mla_forward(m: Dict[str, torch.Tensor], h: torch.Tensor,
                positions: torch.Tensor, cfg: MlaConfig,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_pos=None, spec: Optional[Dict[str, Tuple]] = None,
                cache_spec: Optional[Dict[str, Tuple]] = None
                ) -> torch.Tensor:
    """One MLA layer over its latent slot cache; returns y [B, L, d].

    h: [B, L, d] normed input; positions: [B, L] absolute; cache: ``{"ckv"
    [B, S, kv_lora], "kr" [B, S, qk_rope]}``, written in place.
    ``cache_pos`` selects the case as in :func:`gqa_forward`: a [B] int
    tensor is a decode step, the int 0 a prefill of every slot from
    position 0 (see the module docstring). With ``cache=None`` the
    training forward, K/V expanded (the reference's ``attention.py:
    302-324``).

    On one rank of a mesh (``spec`` / ``cache_spec`` as in
    :func:`gqa_forward`; the reference splits ``w_uq`` / ``w_uk`` /
    ``w_uv``'s columns and ``wo``'s rows by heads and the latents' rows
    over ``kv_seq``): the latents and the rotary key are computed whole
    from the whole ``w_dkv`` / ``w_kr``; a prefill writes the rows its
    cache holds and attends the L new latents for the heads ``wo``'s rows
    take; a decode step writes its position on the rank that holds it
    and, with the rows cut, attends every head over those rows, the
    slices merged with ``combine_partials`` over their line (else the
    heads ``wo``'s rows take). Each head's columns of ``w_uq`` / ``w_uk``
    / ``w_uv`` are gathered over their line where the rank lacks them;
    ``wo``'s partial product is summed over its line."""
    B, L, _ = h.shape
    H, nope, dq, vd = cfg.n_heads, cfg.qk_nope, cfg.qk_nope + cfg.qk_rope, \
        cfg.v_dim
    mesh = sharding.current_mesh()
    spec, cache_spec = spec or {}, cache_spec or {}
    oc = sharding.held(m["wo"], spec.get("wo"), 0, mesh)
    heads_cols = {name: sharding.held(m[name], spec.get(name), 1, mesh)
                  for name in ("w_uq", "w_uk", "w_uv")}
    apart = cache is None and oc.line is not None
    if cache is None:       # the heads wo's rows take: h and the down-
        m, h = _train_entry(m, h, spec, mesh, oc,  # projections entered
                            tuple(heads_cols.values()), "MLA")
    cq = blocks.rms_norm(m["q_norm"], h @ m["w_dq"])
    ckv = blocks.rms_norm(m["kv_norm"], h @ m["w_dkv"])         # [B, L, c]
    k_rope = blocks.apply_rope((h @ m["w_kr"]).reshape(B, L, 1, cfg.qk_rope),
                               positions, cfg.rope_theta)[:, :, 0]
    decode = isinstance(cache_pos, torch.Tensor)
    if cache is not None:
        cc, kc = cache["ckv"], cache["kr"]
        rows = sharding.held(cc, cache_spec.get("ckv"), 1, mesh)
        if not decode and cache_pos != 0:
            raise ValueError(f"mla_forward: cache_pos must be a [B] tensor "
                             f"(decode) or 0 (prefill), got {cache_pos!r}")
        if decode and L != 1:
            raise ValueError(f"mla_forward: a decode step takes one token a "
                             f"slot, got L={L}")
    sp = decode and rows.line is not None
    h_lo, h_hi = (0, H) if sp else (oc.lo // vd, -(-oc.hi // vd))

    def cols(name, width):      # heads [h_lo, h_hi) of a heads_tp leaf
        w = m[name] if name != "w_uq" else cq @ m[name]
        return sharding.take(w, heads_cols[name],
                             (h_lo * width, h_hi * width), apart=apart)[0]
    q = cols("w_uq", dq).reshape(B, L, -1, dq)
    q_nope = q[..., :nope]
    q_rope = blocks.apply_rope(q[..., nope:], positions, cfg.rope_theta)
    if cache is None:
        return _mla_expanded(q_nope, q_rope, ckv, k_rope, cols("w_uk", nope),
                             cols("w_uv", vd), m["wo"], oc, h_lo * vd, cfg)
    w_uk = cols("w_uk", nope).reshape(cfg.kv_lora, -1, nope).float()
    w_uv = cols("w_uv", vd).reshape(cfg.kv_lora, -1, vd).float()
    if decode:
        pos = cache_pos.long()
        _write_position(cc, ckv[:, 0], pos, rows, 1)
        _write_position(kc, k_rope[:, 0], pos, rows, 1)
        keys = rows.lo + torch.arange(cc.shape[1], device=h.device)
        out = _mla_attend(q_nope, q_rope, cc.to(h.dtype), kc.to(h.dtype),
                          (keys[None] <= pos[:, None])[:, None, None],
                          w_uk, w_uv, cfg, return_lse=sp)
        if sp:
            out = sharding.combine_partials(*out, rows.line)
    else:
        r0, r1 = rows.lo, min(rows.hi, L)
        if r1 > r0:
            cc[:, :r1 - r0] = ckv[:, r0:r1].to(cc.dtype)
            kc[:, :r1 - r0] = k_rope[:, r0:r1].to(kc.dtype)
        # the L latents as the cache holds them, read back at h's dtype
        ckv_l = ckv.to(cc.dtype).to(h.dtype)
        kr_l = k_rope.to(kc.dtype).to(h.dtype)
        keys = torch.arange(L, device=h.device)
        out = torch.cat([_mla_attend(
            q_nope[:, r:r + MLA_Q_BLOCK], q_rope[:, r:r + MLA_Q_BLOCK],
            ckv_l, kr_l, keys[None] <= keys[r:r + MLA_Q_BLOCK, None],
            w_uk, w_uv, cfg).to(h.dtype)
            for r in range(0, L, MLA_Q_BLOCK)], dim=1)
    return _out(out.to(h.dtype), m["wo"], oc, h_lo * vd, h.dtype)


def _mla_expanded(q_nope, q_rope, ckv, k_rope, w_uk, w_uv, wo,
                  oc: sharding.Held, lo: int, cfg: MlaConfig
                  ) -> torch.Tensor:
    """The no-cache MLA attention of the heads of q (``w_uk`` / ``w_uv``
    their columns): K = [ckv·w_uk, k_rope on every head], V = ckv·w_uv
    zero-padded from v_dim to qk_nope + qk_rope, causal, through
    :func:`attend_train` with n_kv = the heads and the MLA config's
    chunks; V's padding sliced off, then ``wo``'s rows ``oc`` (the
    output's column ``lo`` first, :func:`_out`) → y [B, L, d]."""
    B, L, H = q_nope.shape[:3]
    dk = cfg.qk_nope + cfg.qk_rope
    k_nope = (ckv @ w_uk).reshape(B, L, H, cfg.qk_nope)
    v = (ckv @ w_uv).reshape(B, L, H, cfg.v_dim)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, L, H, cfg.qk_rope)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if cfg.v_dim != dk:
        v = torch.nn.functional.pad(v, (0, dk - cfg.v_dim))
    out = attend_train(q, k, v, cfg, True)[..., :cfg.v_dim]
    return _out(out, wo, oc, lo, q_nope.dtype)
