"""KV pools for serving: dense slot caches and a page pool.

Counterpart of ``repro/serve/kvcache.py``. :class:`CachePool` is the dense
engine's pool: ``n_slots`` decode slots, each a ``[K, max_seq, hd]`` cache
row per layer (``transformer.init_caches``), whatever its sequence's
length. :class:`PagedCachePool` is the page pool: the pool
holds ``n_pages`` physical pages of ``page_tokens`` rows per layer,
``[count, P, K, pt, hd]`` per group position, so one *logical* page id maps
into every layer's pool at once and each layer's ``[P, K, pt, hd]`` slice
is a contiguous view. A per-sequence
int32 page table translates logical token position to physical page on the
device (kernels/paged_decode_attention.py walks it).

``kv_dtype="int8"`` stores pages quantized (serve/kvquant.py): each layer
position's leaf dict grows ``k_scale`` / ``v_scale`` f32 [count, P, K]
beside the int8 payload. Scales are page state: zeroed on every allocation
(:meth:`PagedCachePool.reset_pages`), copied by COW forks and shared with
their pages. ``kv_dtype="compute"`` keeps pages at the compute dtype.

Shared prefixes (serve/cache.py ``PrefixCachingPool``): a sequence may
adopt ref-counted pages of a cached prefix at admission; its reservation
counts only the pages it draws itself, and a shared page is COW-forked
(:meth:`PagedCachePool.cow_unshare`) before any write lands in it.

Under tensor parallelism (``tp`` ranks, serve/executor.py) a rank's pool
holds kv heads ``[rank·K/tp, (rank+1)·K/tp)`` on axis 2 of every leaf, the
int8 scale leaves included. Everything else is host state and stays whole
and equal on every rank: page ids, tables, lengths, reservations. Byte
counts are whole too (:meth:`PagedCachePool.page_nbytes` counts a page
across all ranks), so budgets and counters read as at tp = 1.

Unlike the reference, page contents are updated **in place**: the paged
steps write into the pool tensors the pool owns, and the executor hands the
same ``pages`` object back, so the scheduler's ``pool.pages = ...`` reads
as it does in the reference.

Ownership boundaries & invariants:

  * This module owns the device page tensors and the host-side slot state
    (seq_ids / lengths). Page identity and refcounts belong to core/vmm.py,
    scheduling to serve/scheduler.py.
  * **Never-fails-mid-decode**: every admitted sequence's reservation
    covers its worst-case page growth, so ``ensure`` on a resident sequence
    cannot raise; pool exhaustion surfaces as an admission refusal.
  * **No-leak accounting**: releasing every slot returns every page to the
    free list (or to the prefix cache's one reference) and empties the
    reservation table.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import vmm
from repro_torch.models import transformer
from repro_torch.serve import kvquant, paged_step, trace

_PAGEABLE = ("gqa", "global", "shared")


class CachePool:
    """Slot-based dense pool: ``n_slots`` decode slots over the model's slot
    caches (``[count, n_slots, K, max_seq, hd]`` leaves at the compute
    dtype; a sliding-window layer's leaves hold a ring of ``min(max_seq,
    window)`` rows; an MLA layer's, its latents ``[count, n_slots,
    max_seq, c]``; a recurrent layer's, its state, constant in
    ``max_seq``). ``lengths[slot]`` counts the slot's KV rows plus the token it
    will decode next; ``seq_ids[slot]`` is -1 when the slot is free. A
    freed slot keeps its rows and state; the next prefill into it writes
    its KV rows and starts its recurrent state from zero
    (models/transformer.py ``recurrent_forward``)."""

    prefix = None       # no prefix index under the dense engine

    def __init__(self, cfg: transformer.ModelConfig, n_slots: int,
                 max_seq: int, device="cpu"):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.caches = transformer.init_caches(cfg, n_slots, max_seq,
                                              device=device)
        self.lengths = np.zeros(n_slots, np.int64)
        self.seq_ids = np.full(n_slots, -1, np.int64)

    def alloc_slot(self, seq_id: int) -> int:
        free = np.where(self.seq_ids < 0)[0]
        if len(free) == 0:
            raise MemoryError("no free decode slots")
        s = int(free[0])
        self.seq_ids[s] = seq_id
        self.lengths[s] = 0
        return s

    def free_slot(self, slot: int) -> None:
        self.seq_ids[slot] = -1
        self.lengths[slot] = 0

    def token_bytes(self) -> int:
        return token_bytes(self.cfg)

    def footprint_bytes(self) -> int:
        """Device memory the pool holds at the reference's 2-byte estimate:
        n_slots × max_seq rows, however short the resident sequences (the
        reference's estimate leaves ring layers out; :meth:`leaf_nbytes`
        counts what the leaves hold)."""
        return self.n_slots * self.max_seq * token_bytes(self.cfg)

    def leaf_nbytes(self) -> int:
        """The bytes the cache leaves really hold, rings and recurrent
        state included."""
        return sum(a.nbytes for per_pos in self.caches for kv in per_pos
                   for a in kv.values())


def token_bytes(cfg: transformer.ModelConfig) -> int:
    """Per-token cache footprint (all layers) for capacity planning, at
    the reference's 2-byte estimate per element; sliding-window rings and
    recurrent state are constant in the sequence length and, as in the
    reference, uncounted (zamba2's ``shared`` sites count, an MLA layer
    its latent and rotary key: ``(kv_lora + qk_rope) × 2``)."""
    total = 0
    for pattern, count in cfg.groups:
        for kind in pattern:
            mixer, _ = transformer.parse_kind(kind)
            if mixer in _PAGEABLE:
                total += count * 2 * cfg.n_kv * cfg.hd * 2
            elif mixer == "mla":
                total += count * (cfg.mla.kv_lora + cfg.mla.qk_rope) * 2
    return total


def check_pageable(cfg: transformer.ModelConfig) -> None:
    """Raise, in the reference's words, unless a page pool can hold every
    layer of ``cfg``: the engine asks before it builds anything else."""
    for pattern, _ in cfg.groups:
        for kind in pattern:
            mixer, _ = transformer.parse_kind(kind)
            if mixer not in _PAGEABLE:
                raise ValueError(
                    f"PagedCachePool: mixer {mixer!r} is not pageable "
                    f"(supported: {_PAGEABLE}); use the dense CachePool")
    if cfg.logit_softcap:
        raise ValueError("PagedCachePool: the paged attention kernels "
                         "have no logit-softcap path; use the dense pool")


class PagedCachePool:
    """Paged serving pool at the compute dtype or in int8.

    Admission is reservation-based: chunked admission reserves and
    allocates the prompt's private pages (``admit_prefill``, after adopting
    any shared prefix pages), promotion tops the reservation up to the
    decode worst case (``reserve_decode``), and decode grows the page list
    on demand (``ensure``), which the reservation guarantees never fails.
    Monolithic admission (``admit``) reserves the decode worst case at
    once, and ``write_prefill`` lands a whole dense prefill in the pages.
    Reservations count *private* pages: shared prefix pages cost the sharer
    nothing, a COW fork counts as one of its own.
    """

    # the bottom of every cache stack has no prefix index; the scheduler
    # reads this uniformly (PrefixCachingPool carries a real one)
    prefix = None

    def __init__(self, cfg: transformer.ModelConfig, max_batch: int,
                 max_seq: int, n_pages: int, page_tokens: int = 16,
                 device="cpu", kv_dtype: str = kvquant.COMPUTE,
                 tp: int = 1, rank: int = 0):
        check_pageable(cfg)
        if cfg.n_kv % tp or not 0 <= rank < tp:
            raise ValueError(f"PagedCachePool: rank {rank} of tp={tp} does "
                             f"not shard {cfg.n_kv} kv heads evenly")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        self.max_pages_per_seq = -(-max_seq // page_tokens)
        self.alloc = vmm.PagedAllocator(n_pages, page_tokens,
                                        max(1, token_bytes(cfg)))
        self.device = torch.device(device)
        self.kv_dtype = kvquant.validate_kv_dtype(kv_dtype)
        self.quantized = self.kv_dtype == kvquant.INT8
        self.tp, self.rank = tp, rank
        dtype = torch.int8 if self.quantized else cfg.compute_dtype
        K, hd = cfg.n_kv // tp, cfg.hd          # this rank's kv heads
        self.pages = []
        for pattern, count in cfg.groups:
            per_pos = []
            for _ in pattern:
                leaf = {name: torch.zeros((count, n_pages, K, page_tokens,
                                           hd), dtype=dtype,
                                          device=self.device)
                        for name in kvquant.PAYLOAD}
                if self.quantized:
                    for name in kvquant.PAYLOAD:
                        leaf[kvquant.SCALE_OF[name]] = torch.zeros(
                            (count, n_pages, K), dtype=torch.float32,
                            device=self.device)
                per_pos.append(leaf)
            self.pages.append(tuple(per_pos))
        self.seq_ids = np.full(max_batch, -1, np.int64)
        self.lengths = np.zeros(max_batch, np.int64)   # valid KV rows per slot
        self._reserved: Dict[int, int] = {}   # seq_id -> PRIVATE pages
        self._shared_base: Dict[int, int] = {}  # seq_id -> adopted pages it
        #                                         will never write
        self.tracer = trace.null_tracer()

    # -- admission --------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_tokens)

    def padded_len(self, n_tokens: int) -> int:
        """n_tokens rounded up to whole pages (a dense prefill's cache)."""
        return self.pages_for(n_tokens) * self.page_tokens

    def _worst_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page need: at least one decoded token's KV lands at
        position prompt_len, so the floor on generated tokens is 1."""
        return self.pages_for(
            min(prompt_len + max(max_new, 1), self.max_seq))

    def _reservation_debt(self) -> int:
        """Reserved-but-not-yet-drawn private pages across resident
        sequences (adopted shared pages count on neither side)."""
        return sum(max(0, reserved - self.alloc.seq_private_pages(sid))
                   for sid, reserved in self._reserved.items())

    def _worst_private(self, seq_id: int, prompt_len: int,
                       max_new: int) -> int:
        """Worst-case *private* page need: the total worst case minus the
        shared prefix pages this sequence will never write."""
        return self._worst_pages(prompt_len, max_new) - \
            self._shared_base.get(seq_id, 0)

    def admissible_ever(self, prompt_len: int, max_new: int) -> bool:
        """False iff the request can never fit, even on an idle pool."""
        worst = self._worst_pages(prompt_len, max_new)
        return (worst <= self.max_pages_per_seq
                and worst <= self.alloc.n_pages
                and prompt_len < self.max_seq)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """Monolithic admission: a slot, and the decode worst case coverable
        now (prompt and every decoded token)."""
        if not np.any(self.seq_ids < 0):
            return False                               # no slot
        if not self.admissible_ever(prompt_len, max_new):
            return False
        return self._worst_pages(prompt_len, max_new) <= \
            self.alloc.free_pages - self._reservation_debt()

    def admit(self, seq_id: int, prompt_len: int, max_new: int) -> int:
        """Reserve the worst case, allocate the prompt's pages, claim a slot
        (the monolithic engine; :meth:`write_prefill` fills the pages)."""
        if seq_id in self.alloc._seq_pages or seq_id in self._reserved:
            raise ValueError(f"paged KV: seq_id {seq_id} already resident "
                             "(page lists would silently merge)")
        if not self.can_admit(prompt_len, max_new):
            raise MemoryError("paged KV: admission refused (out of pages/"
                              "slots)")
        slot = int(np.where(self.seq_ids < 0)[0][0])
        self._reserved[seq_id] = self._worst_pages(prompt_len, max_new)
        self.reset_pages(self.alloc.alloc_seq(seq_id, prompt_len))
        self.seq_ids[slot] = seq_id
        self.lengths[slot] = 0
        return slot

    def _private_prompt_need(self, prompt_len: int, n_shared_pages: int,
                             match_len: int) -> int:
        """Private pages a prefill admission must cover: the unshared prompt
        suffix, plus one page when the shared match ends mid-page (that
        page is COW-forked before the first divergent write lands)."""
        cow = 1 if (n_shared_pages and match_len % self.page_tokens) else 0
        return self.pages_for(prompt_len) - n_shared_pages + cow

    def can_admit_prefill(self, prompt_len: int, max_new: int,
                          n_shared_pages: int = 0, match_len: int = 0) -> bool:
        """Chunked admission needs only the *prompt* pages now (with a
        prefix match, only the unshared suffix and the COW page); the decode
        worst case is topped up at promotion (``reserve_decode``)."""
        if not np.any(self.seq_ids < 0):
            return False                               # no slot
        if not self.admissible_ever(prompt_len, max_new):
            return False
        return self._private_prompt_need(prompt_len, n_shared_pages,
                                         match_len) <= \
            self.alloc.free_pages - self._reservation_debt()

    def admit_prefill(self, seq_id: int, prompt_len: int,
                      shared_pages: Optional[List[int]] = None,
                      match_len: int = 0) -> int:
        """Adopt the shared prefix pages (if any), then reserve and allocate
        the private suffix pages, so every chunk ``[start, start+C)`` lands
        in pages the sequence holds; claim a slot. No decode reservation
        yet. ``shared_pages`` must cover positions ``[0, match_len)`` in
        order; the reservation includes the COW page of a match that ends
        mid-page."""
        shared_pages = list(shared_pages or ())
        if seq_id in self.alloc._seq_pages or seq_id in self._reserved:
            raise ValueError(f"paged KV: seq_id {seq_id} already resident "
                             "(page lists would silently merge)")
        if shared_pages and len(shared_pages) != self.pages_for(match_len):
            raise ValueError(
                f"paged KV: {len(shared_pages)} shared pages do not cover "
                f"match_len {match_len} (need {self.pages_for(match_len)})")
        need = self._private_prompt_need(prompt_len, len(shared_pages),
                                         match_len)
        if need > self.alloc.free_pages - self._reservation_debt() or \
                not np.any(self.seq_ids < 0):
            raise MemoryError("paged KV: prefill admission refused")
        slot = int(np.where(self.seq_ids < 0)[0][0])
        self._reserved[seq_id] = need
        if shared_pages:
            cow = 1 if match_len % self.page_tokens else 0
            self._shared_base[seq_id] = len(shared_pages) - cow
            self.alloc.adopt_pages(seq_id, shared_pages)
        self.reset_pages(self.alloc.alloc_pages(
            seq_id, self.pages_for(prompt_len) - len(shared_pages)))
        self.seq_ids[slot] = seq_id
        self.lengths[slot] = 0
        return slot

    def reserve_extra(self, seq_id: int, n: int = 1) -> bool:
        """Grow a resident sequence's private reservation by ``n`` pages if
        the pool can cover it now (its own partial tail page became shared,
        so its next write must COW-fork). False changes nothing."""
        if seq_id not in self._reserved:
            return False
        if n > self.alloc.free_pages - self._reservation_debt():
            return False
        self._reserved[seq_id] += n
        return True

    def can_reserve_decode(self, seq_id: int, prompt_len: int,
                           max_new: int) -> bool:
        extra = self._worst_private(seq_id, prompt_len, max_new) - \
            self._reserved.get(seq_id, 0)
        return extra <= 0 or \
            extra <= self.alloc.free_pages - self._reservation_debt()

    def reserve_decode(self, seq_id: int, prompt_len: int,
                       max_new: int) -> bool:
        """Top the prompt-only reservation up to the decode worst case (the
        promotion gate), shared pages excluded. False leaves the
        reservation unchanged."""
        if not self.can_reserve_decode(seq_id, prompt_len, max_new):
            return False
        self._reserved[seq_id] = max(
            self._reserved.get(seq_id, 0),
            self._worst_private(seq_id, prompt_len, max_new))
        return True

    def has_decode_reservation(self, seq_id: int, prompt_len: int,
                               max_new: int) -> bool:
        return self._reserved.get(seq_id, 0) >= \
            self._worst_private(seq_id, prompt_len, max_new)

    # -- residency ----------------------------------------------------------
    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow slot's page list so positions < n_tokens are mapped (never
        fails for admitted sequences — the reservation covers it)."""
        sid = int(self.seq_ids[slot])
        self.reset_pages(self.alloc.extend_seq(
            sid, n_tokens - int(self.lengths[slot]),
            int(self.lengths[slot])))

    def cow_unshare(self, slot: int, pos: int) -> bool:
        """Copy-on-write fork of the page mapped at token position ``pos``
        of a resident sequence, iff that page is shared (refcount > 1): the
        allocator swaps the table entry to a fresh private page and every
        pool leaf (payload and, on an int8 pool, scale rows) copies the
        shared page's contents there, on the device, before the caller's
        divergent write. Never fails for admitted sequences (the fork page
        was reserved). Returns True iff a fork happened.

        A copy made while an earlier step is still in flight (the
        overlapped loop's shadow phase) follows that step on the stream, so
        it reads the page as that step left it."""
        sid = int(self.seq_ids[slot])
        if sid < 0:
            raise vmm.StaleSequenceError(
                f"paged KV: cow_unshare of free slot {slot}")
        idx = pos // self.page_tokens
        pages = self.alloc._seq_pages[sid]
        if idx >= len(pages) or self.alloc.refcount(pages[idx]) <= 1:
            return False
        with self.tracer.span("cow_copy", seq_id=sid, page=int(pages[idx])):
            old, new = self.alloc.fork_page(sid, idx)
            for per_pos in self.pages:
                for kv in per_pos:
                    for arr in kv.values():
                        paged_step.copy_page(arr, old, new)
        return True

    def reset_pages(self, page_ids) -> None:
        """Zero the scale rows of freshly (re-)allocated pages of an int8
        pool, in place. A freed page keeps its last scale, and under the
        monotone-max update that stale value would poison the new owner's
        precision; scale 0 marks the page informationless. No-op on a
        compute-dtype pool and on an empty list. Every allocation path
        (``admit_prefill``, ``ensure``) comes through here."""
        if not self.quantized or not page_ids:
            return
        ids = paged_step.page_index(page_ids, self.device)
        for per_pos in self.pages:
            for kv in per_pos:
                for name in kvquant.SCALE_OF.values():
                    kv[name].index_fill_(1, ids, 0.0)

    def release(self, slot: int) -> None:
        """Drop a resident sequence and every page reference it holds."""
        sid = int(self.seq_ids[slot])
        if sid < 0:
            raise vmm.StaleSequenceError(
                f"paged KV: release of free slot {slot} (double release?)")
        self.alloc.free_seq(sid)
        self._reserved.pop(sid, None)
        self._shared_base.pop(sid, None)
        self.seq_ids[slot] = -1
        self.lengths[slot] = 0

    def write_prefill(self, slot: int, caches, length: int) -> None:
        """Scatter a dense B = 1 prefill cache (``transformer.init_caches``
        leaves [count, 1, K, S, hd], S a whole number of pages covering the
        slot's page list) into the slot's pages, one indexed copy per leaf.
        An int8 pool quantizes each page whole through
        ``kvquant.quantize_pages``: the same bytes and scales a chunk
        scatter writes into fresh pages. Under tp the dense cache holds
        every kv head and the rank keeps its own."""
        sid = int(self.seq_ids[slot])
        pages = self.alloc._seq_pages[sid]
        ids = paged_step.page_index(pages, self.device)
        npg, pt = len(pages), self.page_tokens
        for per_pos, dense_pos in zip(self.pages, caches):
            for kv, dense in zip(per_pos, dense_pos):
                for name in kvquant.PAYLOAD:
                    count, _, _, _, hd = dense[name].shape
                    K = kv[name].shape[2]
                    rows = dense[name][:, 0, self.rank * K:(self.rank + 1) * K,
                                       :npg * pt].reshape(
                        count, K, npg, pt, hd).transpose(1, 2)
                    if self.quantized:
                        q, scale = kvquant.quantize_pages(rows)
                        kv[name].index_copy_(1, ids, q)
                        kv[kvquant.SCALE_OF[name]].index_copy_(1, ids, scale)
                    else:
                        kv[name].index_copy_(1, ids, rows.to(kv[name].dtype))
        self.lengths[slot] = length

    # -- host views of the page tables ---------------------------------------
    def device_page_tables(self) -> np.ndarray:
        """[max_batch, max_pages_per_seq] int32, -1 = unmapped (host array;
        the scheduler moves it to the device)."""
        out = np.full((self.max_batch, self.max_pages_per_seq), -1, np.int32)
        for slot in range(self.max_batch):
            sid = int(self.seq_ids[slot])
            if sid >= 0:
                out[slot] = self.alloc.page_table(sid, self.max_pages_per_seq)
        return out

    def page_table_row(self, slot: int) -> np.ndarray:
        """One slot's page-table row (a prefill chunk is one sequence's)."""
        sid = int(self.seq_ids[slot])
        if sid < 0:
            raise ValueError(f"paged KV: page_table_row of free slot {slot}")
        return self.alloc.page_table(sid, self.max_pages_per_seq)

    # -- accounting -------------------------------------------------------
    def page_nbytes(self) -> int:
        """Real bytes one logical page occupies across every pool leaf:
        the payload at its own itemsize plus, on an int8 pool, the scale
        rows; under tp, across every rank's shard."""
        return self.tp * sum(arr.numel() // arr.shape[1] * arr.element_size()
                             for per_pos in self.pages for kv in per_pos
                             for arr in kv.values())

    def footprint_bytes(self) -> int:
        """Device memory held by the page pool."""
        return self.alloc.n_pages * self.page_nbytes()

    def used_bytes(self) -> int:
        return (self.alloc.n_pages - self.alloc.free_pages) * \
            self.page_nbytes()

    def publish_metrics(self, bus) -> None:
        """Page pressure onto the engine metrics bus (observe-only)."""
        bus.set("free_pages", self.alloc.free_pages)
        bus.set("used_pages", self.alloc.n_pages - self.alloc.free_pages)
        bus.set("reservation_debt_pages", self._reservation_debt())
        bus.set("used_bytes", self.used_bytes())
        bus.set("kv_page_nbytes", self.page_nbytes())
        bus.set("kv_footprint_bytes", self.footprint_bytes())
        bus.set("kv_quantized", int(self.quantized))

    def bind_tracer(self, tracer) -> None:
        self.tracer = tracer
