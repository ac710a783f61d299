"""Execution tracer: span timelines + stall-time attribution (HEROv2 §2.4).

HEROv2's case studies stand on "precise, fine-grained, minimally intrusive"
measurement — its double-buffered DMA headline was only tunable because
stall *cycles* were measurable per phase. The serving analogue is this
tracer: the metrics bus (serve/metrics.py) records *what* happened each
iteration (counters, histograms); this module records *where wall time
went*, microsecond by microsecond, so the overlapped-execution work can
drive the measured stalls to zero instead of guessing at them.

Two span families share one bounded ring buffer:

  * **Per-iteration phase spans** on the engine track — ``schedule``,
    ``policy``, ``dispatch``, ``fetch_tokens``, ``swap_wait``, ``cow_copy``,
    ``prefill_chunk`` — nested inside an ``iteration`` root span that the
    scheduler opens around each ``step()``. Device-side work (the async
    dispatch window, DMA transfers in flight) is recorded as **async
    events** on separate ``device``/``dma`` tracks from *observed*
    timestamps (dispatch→host-landing, `TransferHandle.t_start`→`t_done`),
    so overlap shows as real span gaps, never as guessed durations.
  * **Per-request lifecycle spans**, one track per ``seq_id`` — a state
    machine ``queued → prefill → decode → finished`` with ``preempted`` /
    re-``queued`` detours, ``admitted``/``resumed`` instants, and terminal
    ``finished``/``shed`` markers. Reading a request's track answers "where
    did this request's latency go" the way the iteration track answers it
    for the engine.

**Stall attribution** rides on the phase spans: every open span accumulates
its children's wall time, so at close its *self time* (dur − child time) is
exclusive by construction. Self times map onto five buckets — ``schedule``
(schedule + policy spans), ``fetch`` (the one device→host token sync),
``dma`` (blocking swap-DMA waits), ``shadowed`` (host work performed while
a dispatched device step was still in flight — overlapped, not a stall),
``other`` (dispatch, chunk/COW host work, iteration residue) — which
therefore sum to the iteration's wall time *exactly*, not approximately.
The ``shadowed`` relabel is driven by the executor's
:meth:`Tracer.device_dispatch`/:meth:`Tracer.device_landed` signals: a host
span that opens after a dispatch and closes before that step's results land
ran entirely under the device step, so its self time is overlap, not stall
("in flight" means dispatched-and-not-yet-fetched; any residual device wait
still shows up in ``fetch``). :meth:`Tracer.last_iteration` hands the
scheduler each breakdown to publish as ``stall_pct_*`` histograms on the
metrics bus; :meth:`Tracer.stall_summary` aggregates the run.

Export is Chrome trace-event JSON (:meth:`Tracer.chrome_trace` /
:meth:`Tracer.export`): ``ph:"X"`` complete events with µs ``ts``/``dur``,
``ph:"b"``/``"e"`` async pairs for device/DMA windows, ``ph:"i"`` instants,
and ``ph:"M"`` thread-name metadata — load the file in Perfetto (or
chrome://tracing) and the engine/device/dma/request tracks line up on one
timeline (docs/ARCHITECTURE.md shows how to read it).

Ownership boundaries & invariants (tests/test_trace.py):

  * **Tracing is observe-only.** Nothing here mutates scheduler, cache, or
    executor state; instrumented code paths read the clock and append
    records, full stop. Token streams and ``stats_summary()`` are identical
    with tracing on or off.
  * **Disabled ⇒ null-object no-ops** (the MetricsBus pattern):
    ``span()``/``iteration()`` return one shared inert context manager,
    lifecycle/async records return immediately, and no stall histograms
    are published — a disabled-tracer engine is bit-identical (streams AND
    ``metrics_snapshot()``) to one that never constructed a tracer.
  * **One clock.** ``now()`` delegates to the injected monotonic clock
    (default ``time.perf_counter``) whether or not tracing is enabled — the
    scheduler routes ALL of its timing (submit stamps, TTFT/ITL, policy
    ``now``) through it, so a fake clock makes the whole serve layer
    time-deterministic end to end.
  * **Bounded memory.** Completed events land in a ``deque(maxlen=buffer)``
    ring: the oldest events drop first and ``dropped`` counts them — a
    long-running engine never grows without bound, and the exported trace
    is always the most recent window.
"""
from __future__ import annotations

import collections
import json
import time
from typing import Any, Callable, Deque, Dict, List, Optional

# ring-buffer default: ~64k events ≈ a few thousand iterations of a busy
# engine — deep enough for any bench window, bounded on a long-running one
DEFAULT_BUFFER = 65536

# how many per-iteration stall breakdowns to retain (one dict per step)
STALL_WINDOW = 4096

# span name -> exclusive stall bucket; everything unlisted is host "other".
# A span fully under an in-flight device step is relabelled "shadowed"
# (overlapped host work, not stall) — see _Span.__exit__; fetch_tokens is
# never shadowed (it IS the blocking sync point).
_BUCKET = {
    "schedule": "schedule",
    "policy": "schedule",
    "fetch_tokens": "fetch",
    "swap_wait": "dma",
}
BUCKETS = ("schedule", "fetch", "dma", "shadowed", "other")

# trace-track thread ids (pid is always 0 — one engine process)
TID_ENGINE = 0
TID_DEVICE = 1
TID_DMA = 2
TID_REQ_BASE = 100          # request seq_id s renders on tid 100 + s

# request lifecycle states that end the track (span closed, entry dropped)
_TERMINAL = ("finished", "shed")


class _NullSpan:
    """Shared inert context manager for the disabled tracer (cf. the
    MetricsBus null objects): entering/exiting costs two attribute lookups
    and no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One open phase span: context manager pushed on the tracer's stack.

    ``child`` accumulates completed children's wall time so ``__exit__``
    can compute exclusive self time — the stall buckets sum to the
    iteration span exactly because every microsecond is counted once."""

    __slots__ = ("tracer", "name", "args", "t0", "child", "is_iter",
                 "shadow0", "closes0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any],
                 is_iter: bool = False):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.child = 0.0
        self.is_iter = is_iter

    def __enter__(self):
        tr = self.tracer
        self.t0 = tr.clock()
        # device-busy snapshot: if work is in flight now and it has not
        # landed by __exit__, this span ran entirely under the device step
        self.shadow0 = tr._dev_depth > 0
        self.closes0 = tr._dev_closes
        if self.is_iter:
            tr._iter += 1
            tr._buckets = dict.fromkeys(BUCKETS, 0.0)
        tr._stack.append(self)
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        t1 = tr.clock()
        assert tr._stack and tr._stack[-1] is self, "span close out of order"
        tr._stack.pop()
        dur = t1 - self.t0
        if tr._stack:
            tr._stack[-1].child += dur
        self_time = dur - self.child
        if tr._buckets is not None:
            bucket = _BUCKET.get(self.name, "other")
            if (self.shadow0 and not self.is_iter
                    and self.name != "fetch_tokens"
                    and tr._dev_closes == self.closes0):
                bucket = "shadowed"
            tr._buckets[bucket] += self_time
        tr._push({"ph": "X", "name": self.name, "tid": TID_ENGINE,
                  "cat": "iteration" if self.is_iter else "phase",
                  "t": self.t0, "dur": dur, "args": self.args})
        if self.is_iter:
            entry = {"iter": tr._iter, "t": self.t0, "dur": dur,
                     "buckets": tr._buckets}
            tr._buckets = None
            tr._stall.append(entry)
            tr._last_iter = entry
        return False


class Tracer:
    """Span-based execution tracer for one engine (see module docstring).

    ``enabled=False`` keeps ``now()`` working (the injected clock is the
    serve layer's one timing source either way) but turns every recording
    call into a no-op — the MetricsBus discipline, so measurement never
    perturbs scheduling.
    """

    def __init__(self, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 buffer: int = DEFAULT_BUFFER):
        self.enabled = enabled
        self.clock = clock if clock is not None else time.perf_counter
        self.buffer = int(buffer)
        self.epoch = self.clock()
        self.events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.buffer)
        self.dropped = 0
        self._stack: List[_Span] = []
        self._iter = -1
        self._buckets: Optional[Dict[str, float]] = None
        self._stall: Deque[Dict[str, Any]] = collections.deque(
            maxlen=STALL_WINDOW)
        self._last_iter: Optional[Dict[str, Any]] = None
        self._req_open: Dict[int, Dict[str, Any]] = {}  # sid -> {state, t0}
        self._async_id = 0
        self._dev_depth = 0          # dispatched-not-yet-fetched device steps
        self._dev_closes = 0         # total landings (shadow-window fencing)

    # -- clock (the serve layer's one timing source) -----------------------
    def now(self) -> float:
        return self.clock()

    # -- phase spans -------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager for one engine-track phase span."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def iteration(self, **args):
        """The per-step root span: opens a fresh stall-bucket accumulator,
        closes it into the stall log (``last_iteration``) on exit."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, "iteration", args, is_iter=True)

    # -- async device / dma records (observed timestamps) ------------------
    def async_span(self, track: str, name: str, t_start: float,
                   t_end: float, **args) -> None:
        """Record an async window on the ``device`` or ``dma`` track from
        timestamps *observed* at the endpoints (dispatch / handle stamps) —
        overlap with host spans shows as real gaps, never guesses."""
        if not self.enabled:
            return
        self._async_id += 1
        tid = TID_DMA if track == "dma" else TID_DEVICE
        self._push({"ph": "b", "name": name, "tid": tid, "cat": track,
                    "t": t_start, "id": self._async_id, "args": args})
        self._push({"ph": "e", "name": name, "tid": tid, "cat": track,
                    "t": t_end, "id": self._async_id, "args": {}})

    # -- device-busy signal (overlap attribution) ---------------------------
    def device_dispatch(self) -> None:
        """Executor signal: a device step was just dispatched (async, still
        in flight). Host spans that open while work is in flight and close
        before it lands book their self time as ``shadowed`` — overlapped
        work, not stall. Observe-only: nothing reads this to schedule."""
        if not self.enabled:
            return
        self._dev_depth += 1

    def device_landed(self) -> None:
        """Executor signal: the in-flight device work's results landed on
        the host (the blocking token fetch returned)."""
        if not self.enabled:
            return
        self._dev_depth = 0
        self._dev_closes += 1

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._push({"ph": "i", "name": name, "tid": TID_ENGINE,
                    "cat": "mark", "t": self.clock(), "args": args})

    # -- per-request lifecycle ---------------------------------------------
    def request_state(self, seq_id: int, state: str) -> None:
        """Advance one request's lifecycle state machine: close the open
        state span on its track, then open ``state`` (or, for terminal
        ``finished``/``shed``, mark an instant and retire the track).
        Re-asserting the current state is a no-op."""
        if not self.enabled:
            return
        sid = int(seq_id)
        open_rec = self._req_open.get(sid)
        if open_rec is not None and open_rec["state"] == state:
            return
        t = self.clock()
        tid = TID_REQ_BASE + sid
        if open_rec is not None:
            self._push({"ph": "X", "name": open_rec["state"], "tid": tid,
                        "cat": "request", "t": open_rec["t0"],
                        "dur": t - open_rec["t0"], "args": {"seq_id": sid}})
        if state in _TERMINAL:
            self._req_open.pop(sid, None)
            self._push({"ph": "i", "name": state, "tid": tid,
                        "cat": "request", "t": t, "args": {"seq_id": sid}})
        else:
            self._req_open[sid] = {"state": state, "t0": t}

    def request_instant(self, seq_id: int, name: str) -> None:
        """A point event on one request's track (``admitted``,
        ``resumed``) — the state machine is not advanced."""
        if not self.enabled:
            return
        sid = int(seq_id)
        self._push({"ph": "i", "name": name, "tid": TID_REQ_BASE + sid,
                    "cat": "request", "t": self.clock(),
                    "args": {"seq_id": sid}})

    # -- stall attribution --------------------------------------------------
    def last_iteration(self) -> Optional[Dict[str, Any]]:
        """The most recent iteration's breakdown: ``{"iter", "t", "dur",
        "buckets": {schedule, fetch, dma, shadowed, other}}`` — bucket
        seconds sum to ``dur`` exactly (self-time accounting). None before
        the first iteration or when disabled."""
        return self._last_iter

    def stall_log(self) -> List[Dict[str, Any]]:
        """Per-iteration breakdowns, oldest first (bounded window)."""
        return list(self._stall)

    def stall_summary(self) -> Dict[str, Any]:
        """Run-level aggregate: total iteration wall seconds and each
        bucket's share of it (percent). Zeros when nothing was traced."""
        total = sum(e["dur"] for e in self._stall)
        out: Dict[str, Any] = {"iterations": len(self._stall),
                               "wall_s": total}
        for b in BUCKETS:
            acc = sum(e["buckets"][b] for e in self._stall)
            out[f"stall_pct_{b}"] = 100.0 * acc / total if total > 0 else 0.0
        return out

    def stats(self) -> Dict[str, int]:
        return {"events": len(self.events), "dropped": self.dropped,
                "iterations": self._iter + 1}

    # -- ring buffer --------------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) == self.buffer:
            self.dropped += 1
        self.events.append(ev)

    # -- Chrome trace-event export (Perfetto-loadable) ----------------------
    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    def chrome_trace(self) -> Dict[str, Any]:
        """The buffered window as a Chrome trace-event object:
        ``{"traceEvents": [...]}`` with ``ph:"M"`` thread names first, then
        the ring buffer in completion order (µs timestamps relative to the
        tracer's construction epoch).

        After a ring wrap a parent span can survive eviction of its children
        (events push at span *close*, so children precede their parent in the
        ring): any retained span that *started* at or before the oldest
        retained event's timeline position may have lost children, so it is
        exported with ``args.partial = true`` — readers must not assume its
        child spans close it exactly. Over-marking is safe; under-marking
        would silently break the bucket-closure contract."""
        names = {TID_ENGINE: "engine", TID_DEVICE: "device", TID_DMA: "dma"}
        seen_tids = {ev["tid"] for ev in self.events}
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "repro-serve engine"}}]
        for tid in sorted(seen_tids):
            label = names.get(tid, f"req {tid - TID_REQ_BASE}")
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid, "args": {"name": label}})
        cutoff = None
        if self.dropped > 0 and self.events:
            cutoff = self.events[0]["t"]
        for ev in self.events:
            out = {"ph": ev["ph"], "name": ev["name"], "pid": 0,
                   "tid": ev["tid"], "cat": ev["cat"],
                   "ts": self._us(ev["t"]), "args": ev["args"]}
            if ev["ph"] == "X":
                out["dur"] = ev["dur"] * 1e6
                if cutoff is not None and ev["t"] <= cutoff:
                    out["args"] = dict(ev["args"], partial=True)
            elif ev["ph"] in ("b", "e"):
                out["id"] = ev["id"]
            elif ev["ph"] == "i":
                out["s"] = "t"
            events.append(out)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "iterations": self._iter + 1}}

    def export(self, path: str) -> str:
        """Write :meth:`chrome_trace` as JSON; load in Perfetto or
        chrome://tracing. Returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")
        return path


_NULL_TRACER: Optional[Tracer] = None


def null_tracer() -> Tracer:
    """The shared disabled tracer: layers constructed without an engine
    (direct Scheduler/pool use in tests) default to it — ``now()`` works,
    every recording call is a no-op, and nothing ever accumulates."""
    global _NULL_TRACER
    if _NULL_TRACER is None:
        _NULL_TRACER = Tracer(enabled=False, buffer=1)
    return _NULL_TRACER
