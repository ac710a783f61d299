"""SLO-aware scheduler policy: priority/deadline classes, load shedding,
and token-budget mix shaping over the metrics bus.

A copy of ``repro/serve/policy.py`` (pure Python), importing the port's
metrics bus; tests/test_torch_policy.py holds its plans and the engine's
verdicts against the reference.

The scheduler (serve/scheduler.py) is deliberately mechanism-only: mailbox
drain, page-reservation admission, token-budget packing. This module is the
*policy* that sits in front of those mechanisms and consumes the per-
iteration signals the metrics bus (serve/metrics.py) carries:

  * **Priority classes** — every :class:`repro_torch.serve.scheduler.Request`
    carries an integer ``priority`` (larger = more urgent). Each admission
    pass the mailbox is reordered by *effective* priority: the request's
    class plus one **aging** boost per ``age_iters`` passes waited — so
    high classes admit first, but a low-class request's effective class
    eventually overtakes any fixed class ceiling and it is never starved
    beyond a bounded wait. Ties break earliest-deadline-first, then
    submission order.
  * **Admission gate** — ``max_in_system`` caps how many requests may be
    resident (hot + cold) at once. The tiered stack would otherwise admit
    *everything* by preempting LRU residents, and the oversubscribed regime
    collapses into swap churn (the tiered bench's 29 admission refusals).
    The gate stops the drain *before* the pool refuses — a quiet "not yet",
    not a refusal stat and a requeue storm.
  * **Load shedding** — ``max_queue`` bounds the waiting line. Beyond it,
    the lowest-effective-priority tail is rejected with a typed
    :class:`ShedVerdict` (code ``"overload"``); a request whose ``deadline_s``
    has already lapsed before admission sheds with code ``"deadline"``.
    Shedding is decided *before* admission ever touches the pool, so a shed
    request never owned a page, a reservation, or a slot — accounting
    closes by construction.
  * **Mix shaping** — when the decode inter-token-latency p99 (windowed
    ``itl_s`` histogram) exceeds ``itl_target_s``, the prefill share of the
    token budget is squeezed to its floor: one token per mid-prefill
    resident. That floor preserves the scheduler's fair-share/no-starvation
    invariant (every mid-prefill resident still progresses every iteration)
    while giving decode streams the rest of the budget back.

Ownership boundaries & invariants:

  * **Policy is the only layer that may shed.** Every other layer either
    serves a request or requeues it intact; only :meth:`SchedulerPolicy.plan`
    may reject one, and always with a typed verdict on ``req.verdict``.
  * **Policy never touches pages.** It reorders and trims the *mailbox*
    (requests that hold no cache state) and scales the *budget*; page
    accounting stays in the cache stack. Requests that were ever admitted
    (hold or held pages, or are cold in the host tier) are never shed.
  * **Streams are policy-invariant**: ordering, gating, shedding, and
    shaping change *which* requests run and *when* — never the tokens an
    admitted greedy request streams (bit-identical to the policy-free
    scheduler; property-tested).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.metrics import MetricsBus


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Declarative policy knobs (all optional — an all-default config only
    reorders by priority/aging and sheds nothing).

    ``age_iters``: admission passes a waiting request ages before its
    effective priority rises by one class. ``max_in_system``: resident-
    request cap enforced at the admission gate (None = pool capacity
    decides). ``max_queue``: waiting-line cap beyond which the lowest-
    priority tail sheds (None = unbounded queue). ``itl_target_s``: decode
    inter-token-latency p99 target for budget shaping (None = no shaping).
    """
    age_iters: int = 8
    max_in_system: Optional[int] = None
    max_queue: Optional[int] = None
    itl_target_s: Optional[float] = None

    def __post_init__(self):
        if self.age_iters < 1:
            raise ValueError(f"age_iters must be >= 1, got {self.age_iters}")
        if self.max_in_system is not None and self.max_in_system < 1:
            raise ValueError("max_in_system must be >= 1 (the engine could "
                             f"never run anything), got {self.max_in_system}")
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")


@dataclasses.dataclass(frozen=True)
class ShedVerdict:
    """Typed rejection attached to ``Request.verdict`` when policy sheds.

    ``code`` is machine-readable (``"overload"`` — queue cap exceeded;
    ``"deadline"`` — the request's deadline lapsed before admission);
    ``reason`` is the human-readable line the driver logs. ``t_shed`` is
    the engine-clock time of the decision."""
    code: str
    reason: str
    t_shed: float


class SchedulerPolicy:
    """One engine's policy state: per-request wait counters + the decision
    procedures. The scheduler calls :meth:`plan` once per admission pass
    (BEFORE draining the mailbox into the pool), :meth:`may_admit` inside
    the drain loop, and :meth:`prefill_allowance` when packing chunks."""

    def __init__(self, config: PolicyConfig, bus: Optional[MetricsBus] = None):
        self.config = config
        self.bus = bus if bus is not None else MetricsBus(enabled=False)
        self._waits: Dict[int, int] = {}       # seq_id -> admission passes
        self._order: Dict[int, int] = {}       # seq_id -> submission tiebreak
        self._submitted = 0
        self.shed_count = 0

    # -- bookkeeping -------------------------------------------------------
    def note_submitted(self, req) -> None:
        if req.seq_id not in self._order:
            self._order[req.seq_id] = self._submitted
            self._submitted += 1
            self._waits.setdefault(req.seq_id, 0)

    def note_admitted(self, req) -> None:
        self._waits.pop(req.seq_id, None)

    def effective_priority(self, req) -> int:
        """Class + aging boost: one class per ``age_iters`` passes waited."""
        waits = self._waits.get(req.seq_id, 0)
        return int(req.priority) + waits // self.config.age_iters

    def waits(self, req) -> int:
        return self._waits.get(req.seq_id, 0)

    # -- the per-pass decision ---------------------------------------------
    def plan(self, pending: Sequence, *, now: float, in_system: int,
             sheddable) -> Tuple[List, List]:
        """Order and trim one admission pass's waiting line.

        ``pending`` is the drained mailbox (FIFO order); ``in_system`` the
        resident-request count (hot + cold + in-flight swap); ``sheddable``
        a predicate — False for requests that hold engine state (cold
        residents, evict-reprefill returnees) and therefore must survive.
        Returns ``(keep, shed)``: ``keep`` in admission order (requeue it
        front-to-back), ``shed`` as ``(req, ShedVerdict)`` pairs. Wait
        counters age every request that stays queued."""
        cfg = self.config
        keep: List = []
        shed: List[Tuple[object, ShedVerdict]] = []
        for req in pending:
            self.note_submitted(req)       # requeued preemptions re-enter
            if (sheddable(req) and req.deadline_s is not None
                    and now - req.t_submit > req.deadline_s):
                shed.append((req, ShedVerdict(
                    code="deadline",
                    reason=f"deadline {req.deadline_s:.3f}s lapsed "
                           f"{now - req.t_submit:.3f}s after submit",
                    t_shed=now)))
                continue
            keep.append(req)
        # effective-priority order: class+aging desc, deadline asc, FIFO
        keep.sort(key=self._sort_key)
        if cfg.max_queue is not None:
            # the waiting line is whatever the gate will not admit this
            # pass; trim its sheddable tail (lowest effective priority,
            # latest submission) down to the cap
            room = cfg.max_queue
            if cfg.max_in_system is not None:
                room += max(0, cfg.max_in_system - in_system)
            over = [r for r in keep if sheddable(r)]
            n_shed = max(0, len(keep) - room)
            for req in reversed(over[:]):
                if n_shed == 0:
                    break
                keep.remove(req)
                shed.append((req, ShedVerdict(
                    code="overload",
                    reason=f"queue cap {cfg.max_queue} exceeded with "
                           f"{in_system} in system",
                    t_shed=now)))
                n_shed -= 1
        for req in keep:
            self._waits[req.seq_id] = self._waits.get(req.seq_id, 0) + 1
        self.shed_count += len(shed)
        for _ in shed:
            self.bus.inc("shed_requests")
        return keep, shed

    def _sort_key(self, req):
        dl = (req.t_submit + req.deadline_s) if req.deadline_s is not None \
            else float("inf")
        return (-self.effective_priority(req), dl, self._order[req.seq_id])

    # -- the admission gate ------------------------------------------------
    def may_admit(self, in_system: int) -> bool:
        """Concurrency gate: False stops the drain quietly (the request
        stays queued — no refusal stat, no pool churn)."""
        cfg = self.config
        return cfg.max_in_system is None or in_system < cfg.max_in_system

    # -- budget shaping ----------------------------------------------------
    def prefill_allowance(self, budget_left: int, n_mids: int) -> int:
        """Shape the post-decode budget share prefill chunks may consume.

        When the windowed decode ITL p99 exceeds the target, prefill is
        squeezed to its *floor* — one token per mid-prefill resident — so
        decode streams recover while every prefilling request still makes
        progress (the fair-share/no-starvation invariant is preserved:
        whenever the shaped remainder covers all residents, all are
        chunked). Without a target, or without signal yet, the full
        remainder passes through."""
        cfg = self.config
        if cfg.itl_target_s is None or budget_left <= 0 or n_mids == 0:
            return max(0, budget_left)
        itl_p99 = self.bus.hist_percentile("itl_s", 99)
        if itl_p99 is None or itl_p99 <= cfg.itl_target_s:
            return budget_left
        self.bus.inc("itl_budget_squeezes")
        return min(budget_left, n_mids)
