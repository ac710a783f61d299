"""Tiered KV cache: a hot tier of pages on the card over a host-DRAM swap tier.

Counterpart of ``repro/serve/tiering.py`` (HEROv2 §2.4: host and
accelerator share data through one DMA API). Device memory holds only the
*hot* working set of KV pages (the :class:`PagedCachePool` below);
preempted sequences live in host DRAM, budgeted by the ``HeroMemory`` L3
level, and move page by page over ``hero_memcpy_dev2host_async`` /
``hero_memcpy_host2dev_async`` (core/dma.py: pinned host buffers, one copy
stream, events).

Swap phasing follows AutoDMA's load / execute / store pipeline:

* **swap-out** dispatches one ``gather_pages`` per pool leaf on the current
  stream and starts that leaf's dev→host copy on the copy stream before any
  copy is waited on, so the transfers queue back to back and the wait is
  the last one's, not the sum. A swap-out issued while a decode step is
  still in flight (the overlapped loop's shadow phase) queues its gathers
  behind that step, and its wait blocks on it, as ``block_until_ready``
  does in JAX.
* **swap-in** is split: ``swap_in_start`` claims a slot and fresh pages and
  starts every host→dev copy; ``swap_in_finish`` orders the current stream
  after them and scatters the rows into the pool. The engine starts a
  resume right after dispatching a step and finishes it on the next
  admission pass, so the copies overlap device compute.

Unlike the reference, the tier is a **subclass** of the pool, not a layer
delegating through ``__getattr__``: every ``CacheManager`` member is found
statically, so ``isinstance(pool, CacheManager)`` holds (serve/cache.py).
Pages are updated in place: a swapped-out sequence's freed pages may be
re-allocated and written by the next chunk of the same step, which is safe
because its gathers were queued on the stream first.

Ownership boundaries & invariants (tests/test_torch_tiering.py):

  * This module owns **cross-tier residency**: which sequences live in host
    DRAM, their swap records and the DMA traffic. Hot-tier page accounting
    stays in serve/kvcache.py; victim choice in serve/scheduler.py.
  * A sequence is resident in exactly one tier; releasing everything
    restores both the page pool and the L3 arena.
  * Swap drops only the sequence's own page references (vmm ``free_seq``):
    a page shared with the prefix cache is never yanked from a reader; its
    bits were copied to host first, and resume re-materialises them into
    private pages with the reservation widened to cover the former share.
  * Under tensor parallelism each rank's tier holds its own kv-head shard
    of the swapped pages, and every rank takes the same swap decisions:
    the budget and the byte counters count whole pages
    (``page_nbytes``), as at tp = 1.
  * ``can_swap_out`` True guarantees ``swap_out`` cannot fail mid-eviction
    (the o1heap probe), and a round trip restores every leaf (int8 scales
    included) bit for bit at the same chunk offset.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import dma, heromem, vmm
from repro_torch.models import transformer
from repro_torch.serve import paged_step
from repro_torch.serve.kvcache import PagedCachePool


@dataclasses.dataclass
class ColdSeq:
    """One swapped-out sequence: its KV pages in host DRAM and what resume
    needs. Only the ``n_valid`` pages that cover ``length`` written rows
    travel; a half-prefilled preemptee's unwritten tail is re-allocated on
    resume but never copied."""
    seq_id: int
    length: int                 # valid KV rows at swap-out (chunk offset)
    n_pages: int                # pages owned at swap-out (re-allocated)
    n_valid: int                # pages swapped (they cover `length` rows)
    reserved: int               # reservation restored on resume
    nbytes: int                 # page_nbytes() × n_valid: the L3 budget and
    #                             swap_*_bytes basis (scale rows included)
    mem_handle: int             # heromem L3 allocation handle
    host: List[List[Dict[str, torch.Tensor]]]  # [group][pos]{leaf} rows


@dataclasses.dataclass
class PendingSwapIn:
    """An in-flight host→device prefetch."""
    seq_id: int
    slot: int
    rec: ColdSeq
    handles: List[List[Dict[str, dma.TransferHandle]]]


class TieredCachePool(PagedCachePool):
    """Two-tier paged KV pool: the hot pool on the card, a cold tier in host
    DRAM. Every hot-pool member is the pool's own; this class adds the swap
    and the cold-tier guards. ``admissible_ever`` stays a hot-tier
    question: a sequence must fit in device memory while it runs.

    ``host_budget_bytes`` bounds the cold tier (default: eight hot pools of
    real page bytes); ``last_transfers`` holds the handles of the latest
    swap phase, in issue order, for :func:`dma.device_window_ms`.
    """

    def __init__(self, cfg: transformer.ModelConfig, *args,
                 host_budget_bytes: Optional[int] = None,
                 hero: Optional[heromem.HeroMemory] = None, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        if host_budget_bytes is None:
            # the o1heap power-of-two rounding makes the budget conservative,
            # so size generously, from real page bytes (an int8 pool keeps
            # the same capacity in pages)
            host_budget_bytes = 8 * self.alloc.n_pages * self.page_nbytes()
        self.hero = hero or heromem.HeroMemory(l3_bytes=host_budget_bytes)
        self._cold: Dict[int, ColdSeq] = {}
        self.swap_out_count = 0
        self.swap_in_count = 0
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.last_transfers: List[dma.TransferHandle] = []

    # -- cold-tier admission guards ----------------------------------------
    def admit(self, seq_id: int, prompt_len: int, max_new: int) -> int:
        if seq_id in self._cold:
            raise ValueError(f"tiered KV: seq_id {seq_id} is resident in the "
                             "cold tier (resume it, don't re-admit)")
        return super().admit(seq_id, prompt_len, max_new)

    def admit_prefill(self, seq_id: int, prompt_len: int,
                      shared_pages: Optional[List[int]] = None,
                      match_len: int = 0) -> int:
        if seq_id in self._cold:
            raise ValueError(f"tiered KV: seq_id {seq_id} is resident in the "
                             "cold tier (resume it, don't re-admit)")
        return super().admit_prefill(seq_id, prompt_len,
                                     shared_pages=shared_pages,
                                     match_len=match_len)

    # -- cold-tier state -----------------------------------------------------
    def is_cold(self, seq_id: int) -> bool:
        return seq_id in self._cold

    def cold_seqs(self) -> List[int]:
        return list(self._cold)

    def host_used_bytes(self) -> int:
        return sum(r.nbytes for r in self._cold.values())

    def host_free_bytes(self) -> int:
        return self.hero.capacity(3)

    def publish_metrics(self, bus) -> None:
        """The pool's gauges, then tier pressure and the swap totals (this
        layer owns the swap counters: one writer per counter)."""
        super().publish_metrics(bus)
        bus.set("cold_seqs", len(self._cold))
        bus.set("host_used_bytes", self.host_used_bytes())
        bus.set("host_free_bytes", self.host_free_bytes())
        bus.set_total("swap_out_count", self.swap_out_count)
        bus.set_total("swap_in_count", self.swap_in_count)
        bus.set_total("swap_out_bytes", self.swap_out_bytes)
        bus.set_total("swap_in_bytes", self.swap_in_bytes)

    def _trace_dma(self, name: str, handles, nbytes: int) -> None:
        """One aggregate ``dma``-track window per swap phase: earliest issue
        to latest completion across the batch."""
        self.last_transfers = list(handles)
        if not self.tracer.enabled or not handles:
            return
        self.tracer.async_span(
            "dma", name, min(h.t_start for h in handles),
            max(h.t_done for h in handles), bytes=nbytes, n=len(handles))

    def _valid_pages(self, slot: int) -> int:
        """Pages holding written KV rows: what swap-out moves."""
        sid = int(self.seq_ids[slot])
        owned = len(self.alloc._seq_pages[sid])
        return min(owned, self.pages_for(max(int(self.lengths[slot]), 1)))

    def _slot_bytes(self, slot: int) -> int:
        return self._valid_pages(slot) * self.page_nbytes()

    def can_swap_out(self, slot: int) -> bool:
        """The host budget's o1heap guarantee probe: True means
        ``swap_out(slot)`` cannot fail mid-eviction."""
        if int(self.seq_ids[slot]) < 0:
            return False
        return self.hero.can_alloc(3, self._slot_bytes(slot))

    # -- swap-out: device → host DRAM -----------------------------------------
    def swap_out(self, slot: int) -> int:
        """Evict one resident sequence's valid pages to host DRAM and free
        its hot pages, slot and reservation. Returns its seq_id."""
        sid = int(self.seq_ids[slot])
        if sid < 0:
            raise ValueError(f"tiered KV: swap_out of free slot {slot}")
        page_ids = self.alloc._seq_pages[sid]
        n_valid = self._valid_pages(slot)
        nbytes = n_valid * self.page_nbytes()
        mem = self.hero.malloc(3, nbytes)
        if mem is None:
            raise MemoryError("tiered KV: host-DRAM budget exhausted "
                              f"({nbytes} B for seq {sid})")
        idx = paged_step.page_index(page_ids[:n_valid], self.device)
        clock = self.tracer.clock
        handles = [[{name: dma.hero_memcpy_dev2host_async(
                        paged_step.gather_pages(arr, idx), clock=clock)
                     for name, arr in kv.items()}
                    for kv in per_pos] for per_pos in self.pages]
        flat = [h for row in handles for ent in row for h in ent.values()]
        with self.tracer.span("swap_wait", dir="out", seq_id=sid,
                              bytes=nbytes):
            dma.hero_memcpy_wait_all(flat)
        self._trace_dma("swap_out_dma", flat, nbytes)
        host = [[{name: h.value for name, h in ent.items()} for ent in row]
                for row in handles]
        # resume re-allocates every page as private (a shared prefix is
        # duplicated, not re-adopted), so the restored reservation is the
        # total: private reservation plus the never-written shares
        self._cold[sid] = ColdSeq(
            seq_id=sid, length=int(self.lengths[slot]),
            n_pages=len(page_ids), n_valid=n_valid,
            reserved=(self._reserved.get(sid, len(page_ids))
                      + self._shared_base.get(sid, 0)),
            nbytes=nbytes, mem_handle=mem, host=host)
        self.release(slot)
        self.swap_out_count += 1
        self.swap_out_bytes += nbytes
        return sid

    # -- swap-in: host DRAM → device -----------------------------------------
    def can_resume(self, seq_id: int) -> bool:
        rec = self._cold.get(seq_id)
        if rec is None or not np.any(self.seq_ids < 0):
            return False
        need = max(rec.reserved, rec.n_pages)
        return need <= self.alloc.free_pages - self._reservation_debt()

    def swap_in_start(self, seq_id: int) -> PendingSwapIn:
        """Claim a slot and fresh pages and start every host→dev copy; the
        caller overlaps device work before ``swap_in_finish``."""
        if not self.can_resume(seq_id):
            raise MemoryError(f"tiered KV: cannot resume seq {seq_id} "
                              "(hot tier exhausted or not cold)")
        rec = self._cold[seq_id]
        slot = int(np.where(self.seq_ids < 0)[0][0])
        self._reserved[seq_id] = rec.reserved
        # zero the scale rows of the re-allocation: the unwritten tail pages
        # are filled by later chunk writes, whose monotone-max scale update
        # must start from 0, not from a former owner's scale
        self.reset_pages(self.alloc.alloc_seq(
            seq_id, rec.n_pages * self.page_tokens))
        self.seq_ids[slot] = seq_id
        self.lengths[slot] = 0                # valid only after finish
        clock = self.tracer.clock
        handles = [[{name: dma.hero_memcpy_host2dev_async(
                        self.device, arr, clock=clock)
                     for name, arr in ent.items()}
                    for ent in row] for row in rec.host]
        return PendingSwapIn(seq_id=seq_id, slot=slot, rec=rec,
                             handles=handles)

    def swap_in_finish(self, pending: PendingSwapIn) -> int:
        """Order the current stream after the prefetch and scatter the valid
        pages into the pool: the sequence is resident again (the same KV
        bits, possibly on other pages). Returns the slot."""
        rec = pending.rec
        idx = paged_step.page_index(
            self.alloc._seq_pages[rec.seq_id][:rec.n_valid], self.device)
        flat = [h for row in pending.handles for ent in row
                for h in ent.values()]
        with self.tracer.span("swap_wait", dir="in", seq_id=rec.seq_id,
                              bytes=rec.nbytes):
            dma.hero_memcpy_wait_all(flat)
        self._trace_dma("swap_in_dma", flat, rec.nbytes)
        for per_pos, row in zip(self.pages, pending.handles):
            for kv, ent in zip(per_pos, row):
                for name, arr in kv.items():
                    paged_step.scatter_pages(arr, ent[name].value, idx)
        self.lengths[pending.slot] = rec.length
        self.hero.free(3, rec.mem_handle)
        del self._cold[rec.seq_id]
        self.swap_in_count += 1
        self.swap_in_bytes += rec.nbytes
        return pending.slot

    def swap_in(self, seq_id: int) -> int:
        """Blocking convenience: start and finish in one call."""
        return self.swap_in_finish(self.swap_in_start(seq_id))

    def drop_cold(self, seq_id: int) -> None:
        """Discard a cold sequence without resuming it."""
        rec = self._cold.pop(seq_id, None)
        if rec is None:
            raise vmm.StaleSequenceError(
                f"tiered KV: drop_cold of non-cold seq {seq_id}")
        self.hero.free(3, rec.mem_handle)
