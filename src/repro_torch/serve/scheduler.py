"""Serving scheduler: the dense, monolithic paged and chunked step loops.

Counterpart of ``repro/serve/scheduler.py``. Requests land
in a :class:`~repro_torch.core.offload.Mailbox`; each ``step()`` drains
it, decides which sequences admit, chunk, promote, preempt, or decode, and
dispatches the executor's regions. Three loops, chosen by the engine's
config:

  * **dense** (no page pool, ``paged=False``): admission takes a free slot
    and prefills the whole prompt into the slot's rows of the dense caches;
    one decode step a step over every slot, each at its own position (the
    reference's shared ``cache_pos`` is a fault: models/attention.py);
  * **monolithic paged** (``paged=True, chunked=False``): admission
    reserves the decode worst case, prefills the whole prompt into a dense
    B = 1 cache padded to whole pages and scatters it into the sequence's
    pages (``write_prefill``); a synchronous paged decode step follows;
    under a tiered stack a refused request preempts, as in the chunked loop;
  * **chunked** (``chunked=True``): each iteration packs one decode token
    per stream first and fair-shares the remainder of the token budget over
    mid-prefill residents as prompt chunks, in admission order. Admission
    reserves prompt pages only; the decode worst case tops up at
    promotion.

The dense and monolithic loops flush the sampled ids once a phase
(admission, then decode); the chunked loop once an iteration, and it alone
overlaps (below).

Prefix reuse (a stack with a prefix layer, serve/cache.py): admission
looks up the longest cached prefix of the prompt, adopts its pages and
prefills only the rest; an exact full-prompt hit emits the cached first
token and skips prefill. A shared page is COW-forked before the first write
into it (a decode at its write position, a chunk at its start), and a
completed prompt is inserted into the cache when its first token lands.

Preemption (a tiered stack, ``tiered=True``, serve/tiering.py): a request
the hot tier refuses may enter by swapping the least recently decoded
resident out to host DRAM; the victim goes to the back of the mailbox and
resumes at its chunk offset with its KV and tokens intact. A resident is
exempt until it has decoded ``preempt_quantum`` steps (a mid-prefill one
until it has landed a chunk), so the rotation terminates. A resume's
host→device copies start right after a decode step is dispatched
(``_start_prefetch``) and land at the next admission pass.

Policy (an optional :class:`~repro_torch.serve.policy.SchedulerPolicy`)
acts at three points: a mailbox reorder / shed pass at the top of each step
(priority classes with aging, typed verdicts on ``self.shed``), an
admission-concurrency gate in the drain (a quiet "not yet"), and a
prefill-allowance clamp when packing chunks (ITL-target shaping, floored at
one token per mid-prefill resident). Policy never touches pages and never
changes which tokens an admitted request streams.

Token movement: dispatches return device-resident sampled ids; the
scheduler queues them with their completion logic and materialises them in
ONE ``Executor.fetch_token_ids`` transfer an iteration (a phase, off the
chunked loop).

Overlapped execution (``overlap=True``, the default, chunked loop only):
each ``step()`` first
runs the *shadow phase* (swap-in landings, the admission drain, where cold
resumes only start their copies, the COW pre-fork and the mailbox-head
prefetch) while the previous step's dispatches are still running on the
device, then the one blocking fetch commits the previous iteration's
tokens, then promotion, packing and the new dispatches run against exact
post-commit state. Streams equal the synchronous loop's (``overlap=False``).
Consumers carry identity guards: a request preempted while its step was in
flight discards that token, and greedy resume re-derives it. On the card
this holds because a shadow-phase swap-out queues its gathers on the
compute stream behind the in-flight step, and ``lengths`` advance only at
commit. With a prefix layer the shadow phase also pre-forks the shared
page each in-flight decode will write next (``_cow_prefork``), so fork
counts match the synchronous loop's.

Invariants (held against the reference in tests/test_torch_engine.py,
tests/test_torch_prefix.py, tests/test_torch_tiering.py and
tests/test_torch_policy.py):

  * greedy streams equal the reference engine's on the same weights;
  * a request is in exactly one of: mailbox, prefilling, prefilled_wait,
    active, cold (tiered), shed, or finished;
  * decode + prefill-chunk tokens per iteration never exceed the budget;
  * accounting closes at drain: every page free, no cold sequence, the
    allocator audit clean;
  * exactly one host transfer of token ids per chunked iteration (at most
    one per phase on the dense and monolithic loops).

``extract_unadmitted`` is the fleet's drain hook (serve/router.py).
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
from repro_torch.serve.policy import SchedulerPolicy
from repro_torch.serve.prefix_cache import PrefixMatch


@dataclasses.dataclass
class Request:
    seq_id: int
    prompt: np.ndarray          # [L] int32
    max_new: int = 16
    priority: int = 0           # SLO class (larger = more urgent; policy-read)
    deadline_s: Optional[float] = None  # admission deadline after t_submit
    t_submit: float = 0.0
    t_first: float = 0.0        # time of the first emitted token (TTFT)
    prefill_pos: int = 0        # prompt tokens whose KV has been written
    tokens_out: Optional[List[int]] = None
    t_tokens: Optional[List[float]] = None
    done: bool = False
    verdict: Optional[object] = None    # ShedVerdict when policy rejected it


class Scheduler:
    """Mailbox-batched continuous scheduling over one cache stack.

    ``pool`` is a paged stack (serve/cache.py) or, with ``paged=False``, the
    dense :class:`~repro_torch.serve.kvcache.CachePool`. ``paged``,
    ``chunked``, ``tiered`` and ``overlap`` are taken as given: the Engine
    passes the flags ``EngineConfig.normalized()`` resolved (a
    :class:`TieredCachePool` below turns on preemption)."""

    def __init__(self, cfg: transformer.ModelConfig, pool, executor: Executor,
                 *, n_slots: int, greedy: bool = True, paged: bool = True,
                 chunked: bool = True,
                 token_budget: Optional[int] = None,
                 tiered: bool = False, preempt_quantum: int = 1,
                 overlap: bool = True, metrics: Optional[MetricsBus] = None,
                 policy: Optional[SchedulerPolicy] = None,
                 tracer: Optional[trace.Tracer] = None):
        self.cfg = cfg
        self.pool = pool
        self.executor = executor
        self.greedy = greedy
        self.paged = paged
        self.chunked = chunked
        self.tiered = tiered
        self.preempt_quantum = max(1, preempt_quantum)
        self.overlap = overlap
        self.bus = metrics if metrics is not None else MetricsBus(enabled=False)
        self.tracer = tracer if tracer is not None else trace.null_tracer()
        self.policy = policy
        self.shed: List[Request] = []              # policy-rejected requests
        self._ever_admitted: set = set()           # seq_ids that held pages
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
        self._pending_swapins: List[Tuple[Request, Any]] = []
        self._shadow_activated: set = set()  # slots resumed this shadow
        self._admit_stalled = False
        self._admitted_at = np.zeros(n_slots, np.int64)
        self._last_decoded = np.zeros(n_slots, np.int64)
        self._resident_since = np.zeros(n_slots, np.int64)
        self._chunks_done = np.zeros(n_slots, np.int64)
        self._admit_clock = 0
        self.token_budget = None
        if self.chunked:
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
        req.verdict = None
        self.bus.inc("requests_submitted")
        self.tracer.request_state(req.seq_id, "queued")
        return self.mailbox.put(req)

    @property
    def idle(self) -> bool:
        """True when nothing is resident, queued, or in flight."""
        return (not self.active and not self.prefilling
                and not self.prefilled_wait and len(self.mailbox) == 0
                and not self._pending_swapins
                and not self._fetch_queue and not self._commit_queue)

    def extract_unadmitted(self) -> List[Request]:
        """Take every mailbox request that holds no engine state out of the
        mailbox (the fleet's drain hook: a draining replica hands its
        never-admitted queue to its siblings). Requests that held pages
        (cold residents, evicted re-prefillers) stay, in their order: moving
        them would strand the pool's accounting."""
        pending = self.mailbox.drain(len(self.mailbox))
        keep: List[Request] = []
        out: List[Request] = []
        for req in pending:
            (out if self._sheddable(req) else keep).append(req)
        for req in reversed(keep):
            self.mailbox.requeue(req)
        return out

    def step(self) -> List[Request]:
        """One engine iteration: the policy pass, then the chunked loop's
        token-budgeted step (one host transfer of sampled ids), or the
        dense / monolithic loop's admission pass and decode step (one
        transfer each). Returns the requests that finished this
        iteration."""
        self._finished = []
        with self.tracer.iteration():
            self._policy_pass()
            decoded = False
            if self.chunked:
                decoded = self._step_chunked()
                if not self.overlap:
                    self._flush_tokens()
            elif self.paged:
                with self.tracer.span("schedule"):
                    self._admit_paged()
                self._flush_tokens()
                if self.active:
                    self._dispatch_decode_paged()
                    self._flush_tokens()
                    decoded = True
            else:
                with self.tracer.span("schedule"):
                    self._admit()
                self._flush_tokens()
                if self.active:
                    self._dispatch_decode_dense()
                    self._flush_tokens()
            if self.tiered and decoded and not self.overlap:
                # with this step's releases applied, start the mailbox
                # head's resume now: its copies overlap the next admission
                # pass and land at the top of the next step (the overlapped
                # loop prefetches in its shadow phase)
                self._start_prefetch()
            self._publish_metrics()
        if self.paged:
            self.executor.check_ranks(self.pool)
        self._publish_stall()
        return self._finished

    def run(self, max_steps: int = 1000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_steps):
            if self.idle:
                break
            finished.extend(self.step())
        return finished

    # -- SLO policy hooks ---------------------------------------------------
    def _in_system(self) -> int:
        """Residents the admission gate counts: hot, plus the cold set (an
        in-flight resume stays cold until it lands)."""
        n = len(self.active) + len(self.prefilling) + len(self.prefilled_wait)
        if self.tiered:
            n += len(self.pool.cold_seqs())
        return n

    def _sheddable(self, req: Request) -> bool:
        """Only requests that hold no engine state may shed: never-admitted
        mailbox entries (not cold residents, not evicted re-prefillers)."""
        if req.seq_id in self._ever_admitted:
            return False
        return not (self.tiered and self.pool.is_cold(req.seq_id))

    def _policy_pass(self) -> None:
        """Reorder / shed the mailbox under the policy, once per step,
        before any drain. The admission stall clears when the head changed
        or anything shed, so the new head is tried."""
        if self.policy is None or len(self.mailbox) == 0:
            return
        with self.tracer.span("policy"):
            pending = self.mailbox.drain(len(self.mailbox))
            if not pending:
                return
            head_before = pending[0]
            keep, shed = self.policy.plan(
                pending, now=self.tracer.now(), in_system=self._in_system(),
                sheddable=self._sheddable)
            for req, verdict in shed:
                req.verdict = verdict
                req.done = True
                self.shed.append(req)
                self.stats["shed"] += 1
                self.tracer.request_state(req.seq_id, "shed")
            for req in reversed(keep):
                self.mailbox.requeue(req)
            if self._admit_stalled and \
                    (shed or not keep or keep[0] is not head_before):
                self._admit_stalled = False

    def _note_first_admit(self, req: Request) -> None:
        self._ever_admitted.add(req.seq_id)
        self.stats["admission_order"].append(int(req.seq_id))
        lat = self.tracer.now() - req.t_submit
        self.stats["queue_lat_s"].append(lat)
        self.bus.observe("queue_lat_s", lat)
        self.bus.inc("admissions")
        self.tracer.request_instant(req.seq_id, "admitted")
        if self.policy is not None:
            self.policy.note_admitted(req)

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
        if self.paged:          # the dense pool publishes nothing
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
    def _activate(self, slot: int, req: Request, first_admit: bool) -> None:
        self._admit_clock += 1
        self._admitted_at[slot] = self._admit_clock
        self._last_decoded[slot] = self.stats["decode_steps"]
        self._resident_since[slot] = self.stats["decode_steps"]
        self._chunks_done[slot] = 0
        if self.overlap:
            self._shadow_activated.add(slot)
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
        if first_admit:
            self._note_first_admit(req)
        self.tracer.request_state(req.seq_id, state)

    def _pick_victim(self, exclude: Optional[int] = None) -> Optional[int]:
        """LRU preemption victim: the least recently decoded resident, the
        oldest admission breaking ties. A decoding resident is exempt until
        it has decoded ``preempt_quantum`` steps in this residency, a
        mid-prefill one until it has landed a chunk: every admitted
        sequence progresses before it can be evicted again, so the rotation
        terminates."""
        candidates = dict(self.active)
        candidates.update(self.prefilled_wait)
        candidates.update(self.prefilling)
        best, best_key = None, None
        for slot in candidates:
            if slot == exclude:
                continue
            if self.overlap and slot in self._shadow_activated:
                # resumed in this shadow phase: evicting it before its first
                # dispatch would re-queue a paid swap-in with no progress,
                # and with the one-step commit lag every resume would be
                # stolen by the same pass (the synchronous loop's "the last
                # resumes survive the admission pass", made explicit)
                continue
            if slot in self.active:
                quantum = self.preempt_quantum
                if self.overlap and \
                        self._inflight_decode.get(slot) is self.active[slot]:
                    # the token in flight would be discarded by a preemption
                    # now: it is not progress yet (else a quantum of 1
                    # livelocks, every residency's only token dying)
                    quantum += 1
                if self.stats["decode_steps"] - self._resident_since[slot] \
                        < quantum:
                    continue
            if slot in self.prefilling and self._chunks_done[slot] == 0:
                continue
            if not self.pool.can_swap_out(slot):
                continue
            key = (self._last_decoded[slot], self._admitted_at[slot])
            if best_key is None or key < best_key:
                best, best_key = slot, key
        return best

    def _preempt_until(self, can_fit, exclude: Optional[int] = None) -> bool:
        """Swap LRU residents out to host DRAM until ``can_fit()`` passes.
        False (partial evictions stay: their capacity stays freed) when no
        eligible victim remains."""
        while not can_fit():
            victim = self._pick_victim(exclude)
            if victim is None:
                return False
            vreq = self.active.pop(victim, None)
            if vreq is None:
                vreq = self.prefilling.pop(victim, None)
                if vreq is not None:
                    self.stats["preempted_mid_prefill"] += 1
                else:
                    vreq = self.prefilled_wait.pop(victim)
            self.pool.swap_out(victim)
            self.tracer.request_state(vreq.seq_id, "preempted")
            # back of the queue: the waiting request goes first and the
            # victim resumes in FIFO turn (front only if the mailbox is full)
            if not self.mailbox.put(vreq):
                self.mailbox.requeue(vreq)
            self.stats["preemptions"] += 1
            self._sync_swap_stats()
        return True

    def _sync_swap_stats(self) -> None:
        for k in ("swap_out_count", "swap_in_count", "swap_out_bytes",
                  "swap_in_bytes"):
            self.stats[k] = getattr(self.pool, k)

    def _finish_pending_swapin(self) -> None:
        while self._pending_swapins:
            req, token = self._pending_swapins.pop(0)
            slot = self.pool.swap_in_finish(token)
            self.tracer.request_instant(req.seq_id, "resumed")
            self._activate(slot, req, first_admit=False)
            self._sync_swap_stats()

    def _admit_paged(self):
        """Admit by page availability: the drain stops at the first request
        the pool cannot take (requeued at the front, FIFO preserved).
        The chunked loop reserves only the *prompt* pages: the request
        enters ``prefilling`` and the step loop slices its prompt into
        chunks. The monolithic loop reserves the decode worst case and
        prefills the whole prompt here (``_prefill_whole``).

        Untiered, a refusal stalls admission until a release frees
        capacity. Tiered, a refusal first preempts LRU residents to host
        DRAM, and the stall clears every pass (decode steps expire
        residency quanta, so a retry can progress). A cold request at the
        head resumes instead of admitting: synchronously, or in the
        overlapped loop by starting its copies and draining on.

        With a prefix layer the request adopts the pages of its longest
        cached prefix and prefills only the rest. A page shortage first
        evicts cache entries whose page would really free, re-matching
        after each (an evicted page may have been part of the match); a
        slot shortage never evicts."""
        if self.tiered:
            if not self.active:
                # no decode step will run to land the prefetch: finish it
                # here so the loop always makes progress
                self._finish_pending_swapin()
            self._admit_stalled = False
        if self._admit_stalled:
            return
        while True:
            reqs = self.mailbox.drain(1)
            if not reqs:
                break
            req = reqs[0]
            if self.tiered and self.pool.is_cold(req.seq_id):
                if not self.pool.can_resume(req.seq_id) and \
                        not self._preempt_until(
                            lambda: self.pool.can_resume(req.seq_id)):
                    self.mailbox.requeue(req)
                    self.stats["admission_refusals"] += 1
                    self._admit_stalled = True
                    break
                if self.overlap:
                    # shadow phase: claim the slot and pages now (capacity
                    # stays exact) and start the copies; the wait and the
                    # scatter land at the top of the next step's shadow
                    self._pending_swapins.append(
                        (req, self.pool.swap_in_start(req.seq_id)))
                    self._sync_swap_stats()
                    continue
                slot = self.pool.swap_in(req.seq_id)
                self.tracer.request_instant(req.seq_id, "resumed")
                self._activate(slot, req, first_admit=False)
                self._sync_swap_stats()
                continue
            if self.policy is not None and \
                    not self.policy.may_admit(self._in_system()):
                # concurrency gate: a quiet "not yet", no refusal stat (cold
                # resumes above are exempt: they are in the system already)
                self.mailbox.requeue(req)
                break
            L = len(req.prompt)
            if not self.pool.admissible_ever(L, req.max_new):
                # could never fit even on an idle pool: reject outright
                self.stats["rejected"] = self.stats.get("rejected", 0) + 1
                continue
            if not self.chunked:
                if not self.pool.can_admit(L, req.max_new) and not (
                        self.tiered and self._preempt_until(
                            lambda: self.pool.can_admit(L, req.max_new))):
                    self.mailbox.requeue(req)
                    self.stats["admission_refusals"] += 1
                    self._admit_stalled = True
                    break
                self._prefill_whole(req, L)
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
                if self.tiered and self._preempt_until(
                        lambda: self.pool.can_admit_prefill(
                            L, req.max_new, len(match.pages),
                            match.length)):
                    continue
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
            self._activate(slot, req, first_admit=True)

    def _prefill_whole(self, req: Request, L: int) -> None:
        """Monolithic admission: reserve the decode worst case, prefill the
        whole prompt into a dense B = 1 cache padded to whole pages, and
        scatter it into the sequence's pages."""
        slot = self.pool.admit(req.seq_id, L, req.max_new)
        caches = transformer.init_caches(self.cfg, 1,
                                         self.pool.padded_len(L),
                                         device=self.executor.device)
        toks, = self.executor.to_device(req.prompt[None, :])
        tok_dev, caches = self.executor.prefill_dense(toks, caches)
        self.pool.write_prefill(slot, caches, L)
        self._queue_fetch(
            tok_dev, lambda v, req=req: self._emit(req, int(v[0])))
        req.prefill_pos = L
        self._activate(slot, req, first_admit=True)
        self.stats["prefills"] += 1

    def _prefix_match(self, req: Request) -> PrefixMatch:
        """Prefix-cache lookup for a fresh request (no KV written yet). The
        cached first token is honoured only on the greedy path; otherwise
        the match is trimmed so that at least one position is computed."""
        if self.prefix is None or req.prefill_pos or req.tokens_out:
            return PrefixMatch(length=0, pages=[])
        m = self.pool.match(req.prompt)
        if m.first_token is not None and not self.greedy:
            length = min(m.length, len(req.prompt) - 1)
            m = PrefixMatch(length=length,
                            pages=m.pages[:self.pool.pages_for(length)])
        return m

    # -- the dense loop -------------------------------------------------------
    def _admit(self) -> None:
        """Dense admission: each free slot takes the mailbox head and
        prefills its whole prompt into the slot's cache rows."""
        while np.any(self.pool.seq_ids < 0):
            if self.policy is not None and \
                    not self.policy.may_admit(len(self.active)):
                break
            reqs = self.mailbox.drain(1)
            if not reqs:
                break
            req = reqs[0]
            slot = self.pool.alloc_slot(req.seq_id)
            L = len(req.prompt)
            toks, = self.executor.to_device(req.prompt[None, :])
            tok_dev, self.pool.caches = self.executor.prefill_slot(
                toks, self.pool.caches, slot, L)
            self._queue_fetch(
                tok_dev, lambda v, req=req: self._emit(req, int(v[0])))
            req.prefill_pos = L
            self.pool.lengths[slot] = L + 1
            self.active[slot] = req
            self._note_first_admit(req)
            self.tracer.request_state(req.seq_id, "decode")
            self.stats["prefills"] += 1

    def _dispatch_decode_dense(self) -> None:
        """One decode step over every slot. Slot b writes and attends at its
        own position ``lengths[b] - 1`` (a free slot at 0; its output is
        dropped). The reference passes one shared position, the largest
        length less one, to every slot (models/attention.py)."""
        B = self.pool.n_slots
        toks = np.zeros((B, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.tokens_out[-1]
        toks_d, pos_d = self.executor.to_device(
            toks, np.maximum(self.pool.lengths - 1, 0))
        ids_dev, self.pool.caches = self.executor.decode_dense(
            toks_d, self.pool.caches, pos_d)
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(self.active)
        self.stats["batch_occupancy"].append(len(self.active) / B)
        slots = list(self.active)
        self._queue_fetch(
            ids_dev, lambda v, slots=slots: self._finish_decode_dense(slots, v))

    def _finish_decode_dense(self, slots: List[int], vals: np.ndarray):
        for slot in slots:
            req = self.active[slot]
            self._emit(req, int(vals[slot]))
            self.pool.lengths[slot] += 1
            # dense lengths count KV rows plus the pending token
            if len(req.tokens_out) >= req.max_new or \
               self.pool.lengths[slot] >= self.pool.max_seq - 1:
                req.done = True
                self._finished.append(req)
                del self.active[slot]
                self.pool.free_slot(slot)
                self.tracer.request_state(req.seq_id, "finished")

    # -- paged decode ---------------------------------------------------------
    def _dispatch_decode_paged(self, slots: Optional[List[int]] = None):
        if self.tiered and not self.overlap:
            # land the prefetch started at the end of the previous step (the
            # overlapped loop lands prefetches in its shadow phase instead)
            self._finish_pending_swapin()
        if slots is None:            # the monolithic loop: every decoder
            slots = sorted(self.active)
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
        for slot in slots:
            self._last_decoded[slot] = self.stats["decode_steps"]
        used = self.pool.used_bytes()
        self.stats["peak_used_bytes"] = max(
            self.stats.get("peak_used_bytes", 0), used)
        if self.tiered:
            self.stats["peak_host_bytes"] = max(
                self.stats.get("peak_host_bytes", 0),
                self.pool.host_used_bytes())
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
                # preempted while its step was in flight: the swap-out took
                # the pre-decode KV, and the greedy resume re-derives this
                # token
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

    def _start_prefetch(self) -> None:
        """If the mailbox head is a cold sequence the hot tier can take now,
        start its host→device copies; they land at the next admission pass,
        so the transfer overlaps the host work in between."""
        if self._pending_swapins or not self.pool.cold_seqs():
            return
        head = self.mailbox.drain(1)
        if not head:
            return
        req = head[0]
        if self.pool.is_cold(req.seq_id) and self.pool.can_resume(req.seq_id):
            self._pending_swapins.append(
                (req, self.pool.swap_in_start(req.seq_id)))
        else:
            self.mailbox.requeue(req)

    # -- the unified token-budgeted step --------------------------------------
    def _pack_and_promote(self):
        self._promote_waiters()
        decode_slots = sorted(self.active)
        mid_prefill = sorted(int(r.seq_id) for r in self.prefilling.values())
        budget_left = self.token_budget - len(decode_slots)
        if self.policy is not None:
            # ITL-target shaping: squeeze the prefill share to its floor
            # (one token per mid-prefill resident) while decode latency is
            # over target
            budget_left = self.policy.prefill_allowance(
                budget_left, len(self.prefilling))
        return decode_slots, mid_prefill, budget_left, \
            self._pack_chunks(budget_left)

    def _step_chunked(self) -> bool:
        """One iteration: swap-in landings (tiered), admission, promotion of
        prefilled waiters, budget packing (decode tokens first, then
        fair-shared prompt chunks), the chunk dispatches, then one decode
        step. In overlap mode the landings, admission, COW pre-fork and
        prefetch run in the shadow of the previous iteration's device step,
        and the commit fetch sits between them and the packing. Returns
        True iff a decode step was dispatched."""
        if self.overlap:
            with self.tracer.span("schedule"):
                self._shadow_activated.clear()
                if self.tiered:
                    self._finish_pending_swapin()
                self._admit_paged()             # shadow phase
                if self.prefix is not None:
                    self._cow_prefork()
                if self.tiered:
                    self._start_prefetch()
                    if not self.active and not self.prefilling:
                        # nothing will dispatch this step, so the copies
                        # have no device window to hide behind: land them
                        # now and let this step decode instead of idling
                        self._finish_pending_swapin()
            self._flush_commit()                # the one blocking fetch
            with self.tracer.span("schedule"):
                decode_slots, mid_prefill, budget_left, chunks = \
                    self._pack_and_promote()
        else:
            with self.tracer.span("schedule"):
                if self.tiered:
                    self._finish_pending_swapin()
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
        return bool(decode_slots)

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
        self._chunks_done[slot] += 1
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_chunk_tokens"] += size
        if req.prefill_pos >= len(req.prompt):
            self._queue_fetch(
                tok_dev,
                lambda v, slot=slot, req=req:
                    self._finish_chunk_prefill(slot, req, int(v[0])))

    def _finish_chunk_prefill(self, slot: int, req: Request, tok: int):
        """Prompt completed: stream the first token, index the prompt in the
        prefix cache on the greedy path (its pages become claimable by later
        arrivals, its first token lets an exact re-arrival skip prefill) and
        try promotion."""
        self._emit(req, tok)
        self.stats["prefills"] += 1
        if self.prefilling.get(slot) is not req:
            # preempted while the completing chunk was in flight: the
            # swap-out took the whole prompt's KV and tokens_out now ends in
            # this token, so the resume activates straight past prefill
            return
        del self.prefilling[slot]
        if self.prefix is not None and self.greedy:
            self.pool.insert(req.seq_id, req.prompt, tok)
        if self.pool.reserve_decode(req.seq_id, len(req.prompt),
                                    req.max_new):
            self.active[slot] = req
            self.tracer.request_state(req.seq_id, "decode")
        else:
            self.prefilled_wait[slot] = req

    def _promote_waiters(self):
        """FIFO promotion of prefilled waiters into the decode set. Tiered,
        a blocked head may preempt LRU residents. When nothing is decoding
        or prefilling (so no release can come) the youngest waiter is
        evicted and re-prefills later."""
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
            if not ok and self.tiered:
                ok = self._preempt_until(
                    lambda: self.pool.can_reserve_decode(
                        req.seq_id, L, req.max_new),
                    exclude=head) and \
                    self.pool.reserve_decode(req.seq_id, L, req.max_new)
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
        if self.chunked:
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
