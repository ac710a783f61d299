"""Serving scheduler: the chunked, token-budgeted step loop over a paged pool.

Counterpart of the chunked branch of ``repro/serve/scheduler.py`` (no swap
tier, no policy: later slices; greedy only). Requests land in a
:class:`~repro_torch.core.offload.Mailbox`; each ``step()`` drains it,
decides which sequences admit, chunk, promote, or decode, and dispatches
the executor's regions. Each iteration packs one decode token per stream
first and fair-shares the remainder of the token budget over mid-prefill
residents as prompt chunks, in admission order. Admission reserves prompt
pages only; the decode worst case tops up at promotion.

Prefix reuse (a stack with a prefix layer, serve/cache.py): admission
looks up the longest cached prefix of the prompt, adopts its pages and
prefills only the rest; an exact full-prompt hit emits the cached first
token and skips prefill. A shared page is COW-forked before the first write
into it (a decode at its write position, a chunk at its start), and a
completed prompt is inserted into the cache when its first token lands.

Token movement: dispatches return device-resident sampled ids; the
scheduler queues them with their completion logic and materialises the
whole iteration's ids in ONE ``Executor.fetch_token_ids`` transfer.

Overlapped execution (``overlap=True``, the default): each ``step()`` first
runs the *shadow phase* (the admission drain) while the previous step's
dispatches are still running on the device, then the one blocking fetch
commits the previous iteration's tokens, then promotion, packing and the
new dispatches run against exact post-commit state. Streams equal the
synchronous loop's (``overlap=False``). With a prefix layer the shadow
phase also pre-forks the shared page each in-flight decode will write
next (``_cow_prefork``), so fork counts match the synchronous loop's. On
the card the shadow phase really overlaps: CUDA launches return at once,
and the host→device moves are non-blocking copies from pinned memory
(serve/executor.py).

Invariants (held against the reference in tests/test_torch_engine.py):

  * greedy streams equal the reference engine's on the same weights;
  * decode + prefill-chunk tokens per iteration never exceed the budget;
  * accounting closes at drain: every page free, the allocator audit clean;
  * exactly one host transfer of token ids per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.offload import Mailbox
from repro_torch.models import transformer
from repro_torch.serve import trace
from repro_torch.serve.executor import Executor
from repro_torch.serve.metrics import MetricsBus, percentiles
from repro_torch.serve.prefix_cache import PrefixMatch


@dataclasses.dataclass
class Request:
    seq_id: int
    prompt: np.ndarray          # [L] int32
    max_new: int = 16
    t_submit: float = 0.0
    t_first: float = 0.0        # time of the first emitted token (TTFT)
    prefill_pos: int = 0        # prompt tokens whose KV has been written
    tokens_out: Optional[List[int]] = None
    t_tokens: Optional[List[float]] = None
    done: bool = False


class Scheduler:
    """Mailbox-batched continuous scheduling over one paged cache stack."""

    def __init__(self, cfg: transformer.ModelConfig, pool, executor: Executor,
                 *, n_slots: int, token_budget: Optional[int] = None,
                 overlap: bool = True, metrics: Optional[MetricsBus] = None,
                 tracer: Optional[trace.Tracer] = None):
        self.cfg = cfg
        self.pool = pool
        self.executor = executor
        self.overlap = bool(overlap)
        self.bus = metrics if metrics is not None else MetricsBus(enabled=False)
        self.tracer = tracer if tracer is not None else trace.null_tracer()
        self.prefix = pool.prefix
        self.mailbox = Mailbox(depth=256)
        self.active: Dict[int, Request] = {}       # slot -> decoding request
        self.prefilling: Dict[int, Request] = {}   # slot -> mid-prompt req
        self.prefilled_wait: Dict[int, Request] = {}  # awaiting promotion
        self.stats = {"decode_steps": 0, "prefills": 0, "batch_occupancy": [],
                      "admission_refusals": 0, "preemptions": 0,
                      "preempted_mid_prefill": 0, "evictions_reprefill": 0,
                      "swap_out_count": 0, "swap_in_count": 0,
                      "swap_out_bytes": 0, "swap_in_bytes": 0,
                      "prefill_chunks": 0, "prefill_chunk_tokens": 0,
                      "decode_tokens": 0, "cow_forks": 0,
                      "prefix_hits": 0, "prefix_full_hits": 0,
                      "prefix_shared_tokens": 0, "shed": 0,
                      "admission_order": [],
                      "queue_lat_s": [], "ttft_s": [], "itl_s": [],
                      "iter_log": []}
        self._fetch_queue: List[Tuple[Any, Callable]] = []
        self._commit_queue: List[Tuple[Any, Callable]] = []
        self._finished: List[Request] = []
        self._inflight_decode: Dict[int, Request] = {}  # last dispatch
        self._admit_stalled = False
        self._admitted_at = np.zeros(n_slots, np.int64)
        self._admit_clock = 0
        if token_budget is None:
            token_budget = n_slots + 4 * pool.page_tokens
        if token_budget <= n_slots:
            raise ValueError(
                f"token_budget ({token_budget}) must exceed n_slots "
                f"({n_slots}): decode tokens are packed first, so a "
                "smaller budget could never schedule a prefill chunk")
        self.token_budget = int(token_budget)

    # -- host API ----------------------------------------------------------
    def submit(self, req: Request) -> bool:
        req.t_submit = self.tracer.now()
        req.t_first = 0.0
        req.prefill_pos = 0
        req.tokens_out = []
        req.t_tokens = []
        self.bus.inc("requests_submitted")
        self.tracer.request_state(req.seq_id, "queued")
        return self.mailbox.put(req)

    @property
    def idle(self) -> bool:
        """True when nothing is resident, queued, or in flight."""
        return (not self.active and not self.prefilling
                and not self.prefilled_wait and len(self.mailbox) == 0
                and not self._fetch_queue and not self._commit_queue)

    def step(self) -> List[Request]:
        """One engine iteration: the unified token-budgeted step, with
        exactly one host transfer of sampled ids. Returns the requests that
        finished this iteration."""
        self._finished = []
        with self.tracer.iteration():
            self._step_chunked()
            if not self.overlap:
                self._flush_tokens()
            self._publish_metrics()
        self._publish_stall()
        return self._finished

    def run(self, max_steps: int = 1000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_steps):
            if self.idle:
                break
            finished.extend(self.step())
        return finished

    def _in_system(self) -> int:
        return len(self.active) + len(self.prefilling) + \
            len(self.prefilled_wait)

    def _note_first_admit(self, req: Request) -> None:
        self.stats["admission_order"].append(int(req.seq_id))
        lat = self.tracer.now() - req.t_submit
        self.stats["queue_lat_s"].append(lat)
        self.bus.observe("queue_lat_s", lat)
        self.bus.inc("admissions")
        self.tracer.request_instant(req.seq_id, "admitted")

    def _publish_metrics(self) -> None:
        """End-of-step bus publication (observe-only)."""
        bus = self.bus
        if not bus.enabled:
            return
        s = self.stats
        bus.set("queue_depth", len(self.mailbox))
        bus.set("active", len(self.active))
        bus.set("prefilling", len(self.prefilling))
        bus.set("prefilled_wait", len(self.prefilled_wait))
        bus.set("in_system", self._in_system())
        for k in ("decode_steps", "prefills", "decode_tokens",
                  "prefill_chunks", "prefill_chunk_tokens",
                  "admission_refusals", "preemptions",
                  "preempted_mid_prefill", "evictions_reprefill",
                  "cow_forks", "prefix_hits", "prefix_full_hits",
                  "prefix_shared_tokens"):
            bus.set_total(k, s.get(k, 0))
        n_admitted = len(s["admission_order"])
        if self.prefix is not None and n_admitted:
            bus.set("prefix_hit_rate", s["prefix_hits"] / n_admitted)
        self.pool.publish_metrics(bus)

    def _publish_stall(self) -> None:
        """Publish the just-closed iteration's stall buckets (tracing only)."""
        if not self.tracer.enabled or not self.bus.enabled:
            return
        entry = self.tracer.last_iteration()
        if entry is None or entry["dur"] <= 0.0:
            return
        for bucket, sec in entry["buckets"].items():
            self.bus.observe(f"stall_pct_{bucket}",
                             100.0 * sec / entry["dur"])

    # -- deferred token materialisation ------------------------------------
    def _queue_fetch(self, ids_dev, consumer: Callable) -> None:
        self._fetch_queue.append((ids_dev, consumer))

    def _flush_tokens(self) -> None:
        """Materialise every queued id array in one device→host transfer and
        run the value-dependent completions in dispatch order."""
        if not self._fetch_queue:
            return
        queue, self._fetch_queue = self._fetch_queue, []
        vals = self.executor.fetch_token_ids([a for a, _ in queue])
        for (_, consumer), v in zip(queue, vals):
            consumer(v)

    def _flush_commit(self) -> None:
        """Overlap-mode commit point: the PREVIOUS iteration's ids in one
        blocking transfer, then its completions."""
        if not self._commit_queue:
            return
        queue, self._commit_queue = self._commit_queue, []
        vals = self.executor.fetch_token_ids([a for a, _ in queue])
        for (_, consumer), v in zip(queue, vals):
            consumer(v)
        # the in-flight map means something only between a dispatch and its
        # commit (the shadow COW pre-fork keys on it)
        self._inflight_decode = {}

    def _emit(self, req: Request, tok: int) -> None:
        req.tokens_out.append(tok)
        now = self.tracer.now()
        if req.t_first == 0.0:
            req.t_first = now
            self.stats["ttft_s"].append(now - req.t_submit)
            self.bus.observe("ttft_s", now - req.t_submit)
        elif req.t_tokens:
            gap = now - req.t_tokens[-1]
            self.stats["itl_s"].append(gap)
            self.bus.observe("itl_s", gap)
        req.t_tokens.append(now)

    # -- admission ------------------------------------------------------------
    def _activate(self, slot: int, req: Request) -> None:
        self._admit_clock += 1
        self._admitted_at[slot] = self._admit_clock
        if req.prefill_pos < len(req.prompt):
            self.prefilling[slot] = req
            state = "prefill"
        elif not self.pool.has_decode_reservation(
                req.seq_id, len(req.prompt), req.max_new):
            self.prefilled_wait[slot] = req
            state = "prefill"
        else:
            self.active[slot] = req
            state = "decode"
        self._note_first_admit(req)
        self.tracer.request_state(req.seq_id, state)

    def _admit_paged(self):
        """Admit by page availability: the drain stops at the first request
        the pool cannot take (requeued at the front, FIFO preserved), and a
        refusal stalls admission until a release frees capacity. Admission
        reserves only the *prompt* pages: the request enters
        ``prefilling`` and the step loop slices its prompt into chunks.

        With a prefix layer the request adopts the pages of its longest
        cached prefix and prefills only the rest. A page shortage first
        evicts cache entries whose page would really free, re-matching
        after each (an evicted page may have been part of the match); a
        slot shortage never evicts."""
        if self._admit_stalled:
            return
        while True:
            reqs = self.mailbox.drain(1)
            if not reqs:
                break
            req = reqs[0]
            L = len(req.prompt)
            if not self.pool.admissible_ever(L, req.max_new):
                # could never fit even on an idle pool: reject outright
                self.stats["rejected"] = self.stats.get("rejected", 0) + 1
                continue
            while True:
                match = self._prefix_match(req)
                if self.pool.can_admit_prefill(
                        L, req.max_new, len(match.pages), match.length):
                    break
                if self.prefix is not None and \
                        np.any(self.pool.seq_ids < 0) and \
                        self.pool.evict_cached(1, require_free=True):
                    continue            # reclaimed a cache-pinned page
                match = None
                break
            if match is None:
                self.mailbox.requeue(req)
                self.stats["admission_refusals"] += 1
                self._admit_stalled = True
                break
            slot = self.pool.admit_prefill(req.seq_id, L,
                                           shared_pages=match.pages,
                                           match_len=match.length)
            if match.length:
                req.prefill_pos = match.length
                self.pool.lengths[slot] = match.length
                self.stats["prefix_hits"] += 1
                self.stats["prefix_shared_tokens"] += match.length
            if match.first_token is not None:
                # an exact full-prompt hit: the cached greedy continuation
                # is this request's first token, and prefill is skipped
                self.stats["prefix_full_hits"] += 1
                self._emit(req, match.first_token)
            self._activate(slot, req)

    def _prefix_match(self, req: Request) -> PrefixMatch:
        """Prefix-cache lookup for a fresh request (no KV written yet). The
        port is greedy only, so a full hit's cached first token always
        holds."""
        if self.prefix is None or req.prefill_pos or req.tokens_out:
            return PrefixMatch(length=0, pages=[])
        return self.pool.match(req.prompt)

    # -- decode ---------------------------------------------------------------
    def _dispatch_decode_paged(self, slots: List[int]):
        B = self.pool.max_batch
        toks = np.zeros(B, np.int32)
        for slot in slots:
            toks[slot] = self.active[slot].tokens_out[-1]
            # a shared page at the write position is COW-forked before the
            # divergent write (the first decode after a full hit, or a
            # donor writing into its cache-shared tail page); the fork page
            # was reserved, so neither call can fail
            if self.prefix is not None and self.pool.cow_unshare(
                    slot, int(self.pool.lengths[slot])):
                self.stats["cow_forks"] += 1
            # map the write position before dispatch; the decode
            # reservation guarantees this never fails
            self.pool.ensure(slot, int(self.pool.lengths[slot]) + 1)
        toks_d, tables, lengths, active = self.executor.to_device(
            toks[:, None], self.pool.device_page_tables(),
            self.pool.lengths, np.asarray(slots))
        ids_dev, self.pool.pages = self.executor.decode_paged(
            toks_d, self.pool.pages, tables, lengths, active.long())
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(slots)
        self.stats["batch_occupancy"].append(len(slots) / B)
        used = self.pool.used_bytes()
        self.stats["peak_used_bytes"] = max(
            self.stats.get("peak_used_bytes", 0), used)
        self.stats["peak_in_system"] = max(
            self.stats.get("peak_in_system", 0), self._in_system())
        pairs = [(slot, self.active[slot]) for slot in slots]
        if self.overlap:
            self._inflight_decode = dict(pairs)
        self._queue_fetch(
            ids_dev, lambda v, pairs=pairs: self._finish_decode_paged(pairs, v))

    def _finish_decode_paged(self, pairs: List[Tuple[int, Request]],
                             vals: np.ndarray):
        for slot, req in pairs:
            if self.active.get(slot) is not req:
                continue
            self._emit(req, int(vals[slot]))
            self.pool.lengths[slot] += 1
            # paged lengths count KV rows, hence the -2 (see the reference)
            if len(req.tokens_out) >= req.max_new or \
               self.pool.lengths[slot] >= self.pool.max_seq - 2:
                req.done = True
                self._finished.append(req)
                del self.active[slot]
                self.pool.release(slot)
                self.tracer.request_state(req.seq_id, "finished")
                self._admit_stalled = False       # capacity freed: retry

    # -- the unified token-budgeted step --------------------------------------
    def _pack_and_promote(self):
        self._promote_waiters()
        decode_slots = sorted(self.active)
        mid_prefill = sorted(int(r.seq_id) for r in self.prefilling.values())
        budget_left = self.token_budget - len(decode_slots)
        return decode_slots, mid_prefill, budget_left, \
            self._pack_chunks(budget_left)

    def _step_chunked(self) -> None:
        """One iteration: admission, promotion of prefilled waiters, budget
        packing (decode tokens first, then fair-shared prompt chunks), the
        chunk dispatches, then one decode step. In overlap mode admission
        runs in the shadow of the previous iteration's device step and the
        commit fetch sits between it and the packing."""
        if self.overlap:
            with self.tracer.span("schedule"):
                self._admit_paged()             # shadow phase
                if self.prefix is not None:
                    self._cow_prefork()
            self._flush_commit()                # the one blocking fetch
            with self.tracer.span("schedule"):
                decode_slots, mid_prefill, budget_left, chunks = \
                    self._pack_and_promote()
        else:
            with self.tracer.span("schedule"):
                self._admit_paged()
                decode_slots, mid_prefill, budget_left, chunks = \
                    self._pack_and_promote()
        for slot, req, start, size in chunks:
            self._run_chunk(slot, req, start, size)
        if decode_slots:
            self._dispatch_decode_paged(decode_slots)
        self.stats["iter_log"].append({
            "decode_tokens": len(decode_slots),
            "prefill_tokens": int(sum(c[3] for c in chunks)),
            "prefill_budget": int(max(0, budget_left)),
            "chunks": [(int(r.seq_id), int(start), int(size))
                       for _, r, start, size in chunks],
            "mid_prefill": mid_prefill,
        })
        if self.overlap:
            # this iteration's consumers become the NEXT iteration's commit
            self._commit_queue = self._fetch_queue
            self._fetch_queue = []

    def _cow_prefork(self) -> None:
        """Shadow-phase COW pre-fork (overlapped loop, prefix stack): fork
        the shared page each in-flight decode slot will write at its next
        dispatch (post-commit position ``lengths + 1``) while the device
        step is still running. Slots that finish at the commit are skipped:
        the synchronous loop never forks them. The dispatch-time
        ``cow_unshare`` then finds the page private, so fork counts match
        the synchronous loop's."""
        for slot, req in self.active.items():
            if self._inflight_decode.get(slot) is not req:
                continue          # no token in flight: lengths not advancing
            L = int(self.pool.lengths[slot])
            if len(req.tokens_out) + 1 >= req.max_new or \
                    L + 1 >= self.pool.max_seq - 2:
                continue          # finishes at commit
            if self.pool.cow_unshare(slot, L + 1):
                self.stats["cow_forks"] += 1

    def _pack_chunks(self, budget_left: int
                     ) -> List[Tuple[int, Request, int, int]]:
        """Fair-share the post-decode budget over mid-prefill residents in
        admission order; the shortest remaining prompt finishes first within
        its share."""
        if budget_left <= 0 or not self.prefilling:
            return []
        order = sorted(self.prefilling, key=lambda s: self._admitted_at[s])
        remaining = {s: len(self.prefilling[s].prompt)
                     - self.prefilling[s].prefill_pos for s in order}
        share = dict.fromkeys(order, 0)
        left = budget_left
        while left > 0:
            live = [s for s in order if share[s] < remaining[s]]
            if not live:
                break
            quantum = max(1, left // len(live))
            for s in live:
                take = min(quantum, remaining[s] - share[s], left)
                share[s] += take
                left -= take
                if left == 0:
                    break
        return [(s, self.prefilling[s], self.prefilling[s].prefill_pos,
                 share[s]) for s in order if share[s] > 0]

    def _run_chunk(self, slot: int, req: Request, start: int, size: int):
        """Dispatch one prompt chunk ``[start, start+size)``; when it
        completes the prompt, its sampled first token is queued for this
        iteration's fetch."""
        with self.tracer.span("prefill_chunk", seq_id=int(req.seq_id),
                              start=int(start), size=int(size)):
            if self.prefix is not None and self.pool.cow_unshare(slot, start):
                # the first chunk after a mid-page prefix match writes
                # inside the shared partly filled page: fork it first
                self.stats["cow_forks"] += 1
            toks, table_row = self.executor.to_device(
                req.prompt[start:start + size][None, :],
                self.pool.page_table_row(slot))
            tok_dev, self.pool.pages = self.executor.prefill_chunk(
                toks, self.pool.pages, table_row, int(start))
        req.prefill_pos = start + size
        self.pool.lengths[slot] = req.prefill_pos
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_chunk_tokens"] += size
        if req.prefill_pos >= len(req.prompt):
            self._queue_fetch(
                tok_dev,
                lambda v, slot=slot, req=req:
                    self._finish_chunk_prefill(slot, req, int(v[0])))

    def _finish_chunk_prefill(self, slot: int, req: Request, tok: int):
        """Prompt completed: stream the first token, index the prompt in the
        prefix cache (its pages become claimable by later arrivals, its first
        token lets an exact re-arrival skip prefill) and try promotion."""
        self._emit(req, tok)
        self.stats["prefills"] += 1
        if self.prefilling.get(slot) is not req:
            return
        del self.prefilling[slot]
        if self.prefix is not None:
            self.pool.insert(req.seq_id, req.prompt, tok)
        if self.pool.reserve_decode(req.seq_id, len(req.prompt),
                                    req.max_new):
            self.active[slot] = req
            self.tracer.request_state(req.seq_id, "decode")
        else:
            self.prefilled_wait[slot] = req

    def _promote_waiters(self):
        """FIFO promotion of prefilled waiters into the decode set. When
        nothing is decoding or prefilling (so no release can come) the
        youngest waiter is evicted and re-prefills later."""
        while True:
            order = sorted(self.prefilled_wait,
                           key=lambda s: self._admitted_at[s])
            if not order:
                return
            head = order[0]
            req = self.prefilled_wait[head]
            L = len(req.prompt)
            ok = self.pool.reserve_decode(req.seq_id, L, req.max_new)
            if not ok and self.prefix is not None:
                # reclaim cache-pinned pages that would really free
                while not self.pool.can_reserve_decode(
                        req.seq_id, L, req.max_new) and \
                        self.pool.evict_cached(1, require_free=True):
                    pass
                ok = self.pool.reserve_decode(req.seq_id, L, req.max_new)
            if not ok and not self.active and not self.prefilling and \
                    len(order) > 1:
                self._evict_reprefill(order[-1])
                continue
            if not ok:
                return
            del self.prefilled_wait[head]
            self.active[head] = req
            self.tracer.request_state(req.seq_id, "decode")

    def _evict_reprefill(self, slot: int):
        """Promotion-deadlock breaker: drop the youngest waiter's KV and
        requeue it; it re-prefills from scratch later and greedy determinism
        re-derives the retracted first token."""
        req = self.prefilled_wait.pop(slot)
        self.pool.release(slot)
        req.prefill_pos = 0
        if req.tokens_out:
            req.tokens_out.pop()
            req.t_tokens.pop()
        if req.t_first:
            try:
                self.stats["ttft_s"].remove(req.t_first - req.t_submit)
            except ValueError:
                pass
            req.t_first = 0.0
        self.mailbox.requeue(req)
        self.tracer.request_state(req.seq_id, "queued")
        self.stats["evictions_reprefill"] += 1
        self._admit_stalled = False

    # -- counter summary ------------------------------------------------------
    def stats_summary(self) -> Dict[str, Any]:
        """Engine counters in report form, guarded for the empty engine."""
        occ = self.stats.get("batch_occupancy") or []
        s = self.stats
        out = {k: s.get(k, 0) for k in (
            "decode_steps", "prefills", "admission_refusals", "preemptions",
            "preempted_mid_prefill", "evictions_reprefill", "swap_out_count",
            "swap_in_count", "swap_out_bytes", "swap_in_bytes",
            "prefill_chunks", "prefill_chunk_tokens", "decode_tokens",
            "cow_forks", "prefix_hits", "prefix_full_hits",
            "prefix_shared_tokens", "peak_used_bytes", "peak_host_bytes",
            "peak_in_system")}
        out["mean_occupancy"] = float(np.mean(occ)) if occ else 0.0
        out["token_fetches"] = self.executor.stats.get("token_fetches", 0)
        out["tokens_fetched"] = self.executor.stats.get("tokens_fetched", 0)
        out["tp"] = self.executor.tp
        iters = s.get("iter_log") or []
        out["token_budget"] = self.token_budget
        out["max_iter_tokens"] = max(
            (e["decode_tokens"] + e["prefill_tokens"] for e in iters),
            default=0)
        if self.prefix is not None:
            out.update(self.prefix.stats())
        out["shed"] = s.get("shed", 0)
        out.update(percentiles(s.get("queue_lat_s") or [],
                               prefix="queue_lat_", suffix="_s"))
        out.update(percentiles(s.get("ttft_s") or [],
                               prefix="ttft_", suffix="_s"))
        out.update(percentiles(s.get("itl_s") or [],
                               prefix="itl_", suffix="_s"))
        return out
