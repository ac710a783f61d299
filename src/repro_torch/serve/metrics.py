"""Engine metrics bus: counters, gauges, and windowed histograms.

HEROv2's case studies stand on ``hero_perf``-style counters — "precise,
fine-grained, minimally intrusive" measurement is what makes a platform
explorable. The serving stack's analogue is this bus: one process-local
registry of named metrics that the scheduler (serve/scheduler.py), the cache
stack (serve/kvcache.py / tiering.py / cache.py), and the executor
(serve/executor.py) populate **once per engine iteration**, and that the
policy layer (serve/policy.py) and the serving driver (launch/serve.py) read
— the former to shed load and shape the token budget *online*, the latter to
emit periodic structured-JSON log lines.

Three metric kinds, chosen for the three signal shapes the engine produces:

  * :class:`Counter` — monotone event totals (decode tokens, admission
    refusals, shed requests, swap bytes). ``inc`` adds, ``set_total``
    reconciles against an externally-kept total; both refuse to go
    backwards, so a counter that decreases is a bug surfaced at the write
    site, not a corrupted dashboard.
  * :class:`Gauge` — instantaneous levels (queue depth, resident sets, hot
    free pages, prefix hit-rate). Last write wins.
  * :class:`Histogram` — streaming samples over a bounded sliding window
    (TTFT, inter-token latency, queue latency). The window keeps the
    percentiles *recent* — an SLO controller must react to the last few
    hundred tokens, not the run's lifetime average — and bounds memory on a
    long-running engine. Quantiles use the same linear-interpolation rule as
    ``numpy.percentile`` (unit-pinned in tests/test_metrics.py).

Ownership boundaries & invariants:

  * **Metrics are observe-only.** Nothing in this module mutates engine,
    cache, or executor state; the bus is a sink. Acting on the signals is
    the policy layer's exclusive right (see serve/policy.py).
  * **A disabled bus is free and inert**: every write is a no-op, and
    engine outputs (token streams, stats) are bit-identical with the bus on
    or off — measurement never perturbs scheduling.
  * **Snapshots never allocate on an idle engine**: an empty bus (fresh or
    drained engine) snapshots to plain zeros without touching numpy — the
    PR-3 empty-engine ``stats_summary()`` hardening, extended to the bus.
  * :func:`quantile` / :func:`percentiles` are the repo's ONE quantile
    implementation — ``Engine.stats_summary()`` and benchmarks/common.py
    both delegate here (the duplication they used to carry is regression-
    pinned against ``np.percentile`` in tests/test_metrics.py).
"""
from __future__ import annotations

import collections
import math
from typing import Any, Deque, Dict, Iterable, List, Optional, Sequence, Union

Number = Union[int, float]

# default sliding-window length for histograms: long enough that p99 over a
# serving burst is meaningful, short enough that the controller tracks the
# current regime rather than the run's history
DEFAULT_WINDOW = 1024


# --------------------------------------------------------------------------
# quantile math — the one implementation (numpy-compatible)
# --------------------------------------------------------------------------
def quantile(sorted_vals: Sequence[Number], p: float) -> float:
    """Percentile ``p`` (0..100) of pre-sorted values, using the linear-
    interpolation rule of ``numpy.percentile`` — pure Python so an idle
    snapshot allocates nothing. Empty input returns 0.0 (the empty-engine
    hardening contract)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_vals[0])
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    idx = (p / 100.0) * (n - 1)
    lo = math.floor(idx)
    hi = math.ceil(idx)
    if lo == hi:
        return float(sorted_vals[int(idx)])
    frac = idx - lo
    return float(sorted_vals[lo]) * (1.0 - frac) + float(sorted_vals[hi]) * frac


def percentiles(samples: Iterable[Number], ps: Sequence[Number] = (50, 90, 99),
                prefix: str = "", suffix: str = "") -> Dict[str, float]:
    """``{f"{prefix}p{P}{suffix}": value}`` for each requested percentile —
    the report-form helper ``Engine.stats_summary()`` and the benches share.
    Non-integral P keeps its float spelling (``p99.9``)."""
    vals = sorted(samples)
    out = {}
    for p in ps:
        label = str(int(p)) if float(p).is_integer() else str(p)
        out[f"{prefix}p{label}{suffix}"] = quantile(vals, float(p))
    return out


# --------------------------------------------------------------------------
# metric kinds
# --------------------------------------------------------------------------
class Counter:
    """Monotone event total. ``inc`` adds a non-negative delta; ``set_total``
    reconciles to an absolute value kept elsewhere (pool swap counters) —
    both raise on any attempt to move backwards."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter decrement ({n}) — counters are "
                             "monotone; use a Gauge for levels")
        self.value += n

    def set_total(self, total: Number) -> None:
        if total < self.value:
            raise ValueError(f"counter rollback ({self.value} -> {total}) — "
                             "counters are monotone; use a Gauge for levels")
        self.value = total


class Gauge:
    """Instantaneous level; last write wins."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: Number) -> None:
        self.value = float(v)


class Histogram:
    """Streaming samples over a bounded sliding window.

    ``count``/``total`` cover every observation ever made; the window (and
    therefore the percentiles) covers the most recent ``window`` samples.
    """

    __slots__ = ("window", "count", "total", "_samples")

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = int(window)
        self.count = 0
        self.total = 0.0
        self._samples: Deque[float] = collections.deque(maxlen=self.window)

    def observe(self, v: Number) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self._samples.append(v)

    def __len__(self) -> int:
        return len(self._samples)

    def percentile(self, p: float) -> float:
        return quantile(sorted(self._samples), p)

    def snapshot(self, ps: Sequence[Number] = (50, 90, 99)) -> Dict[str, float]:
        vals = sorted(self._samples)
        out = {"count": self.count, "sum": self.total,
               "mean": (self.total / self.count) if self.count else 0.0,
               "window_n": len(vals),
               "min": vals[0] if vals else 0.0,
               "max": vals[-1] if vals else 0.0}
        for p in ps:
            label = str(int(p)) if float(p).is_integer() else str(p)
            out[f"p{label}"] = quantile(vals, float(p))
        return out


# --------------------------------------------------------------------------
# the bus
# --------------------------------------------------------------------------
class MetricsBus:
    """Named-metric registry for one engine. ``enabled=False`` turns every
    write into a no-op (and ``snapshot()`` into ``{}``) so the disabled
    engine is bit-identical to one that never constructed a bus.

    ``namespace`` tags every snapshot with the owning replica's identity.
    The bus used to assume one process holds one engine, so snapshots were
    anonymous — two twin engines in one process (a fleet of replicas, or
    fake-clock twins in a test) produced indistinguishable dicts that
    collide when merged into fleet-level stats. A namespaced bus stamps
    ``snapshot()["namespace"]`` so aggregation keys on it; ``None`` (the
    single-engine default) leaves the snapshot byte-identical to the
    pre-namespace format."""

    _NULL_COUNTER = None    # shared write-sinks for the disabled bus
    _NULL_GAUGE = None
    _NULL_HIST = None

    def __init__(self, enabled: bool = True, window: int = DEFAULT_WINDOW,
                 namespace: Optional[str] = None):
        self.enabled = enabled
        self.window = window
        self.namespace = namespace
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.hists: Dict[str, Histogram] = {}

    # -- registry ----------------------------------------------------------
    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _null_counter()
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _null_gauge()
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def hist(self, name: str) -> Histogram:
        if not self.enabled:
            return _null_hist()
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram(window=self.window)
        return h

    # -- write sugar (the per-iteration hot path) --------------------------
    def inc(self, name: str, n: Number = 1) -> None:
        if self.enabled:
            self.counter(name).inc(n)

    def set_total(self, name: str, total: Number) -> None:
        if self.enabled:
            self.counter(name).set_total(total)

    def set(self, name: str, v: Number) -> None:
        if self.enabled:
            self.gauge(name).set(v)

    def observe(self, name: str, v: Number) -> None:
        if self.enabled:
            self.hist(name).observe(v)

    # -- read side ---------------------------------------------------------
    def hist_percentile(self, name: str, p: float) -> Optional[float]:
        """Windowed percentile, or None when the histogram has no samples
        yet (callers — the policy layer — must treat 'no signal' as
        distinct from 0.0)."""
        h = self.hists.get(name)
        if h is None or len(h) == 0:
            return None
        return h.percentile(p)

    def snapshot(self, ps: Sequence[Number] = (50, 90, 99)) -> Dict[str, Any]:
        """Structured, ``json.dumps``-able view of every metric. Plain
        Python numbers only; an empty bus returns empty sections without
        allocating anything beyond the dicts themselves."""
        if not self.enabled:
            return {}
        out: Dict[str, Any] = {}
        if self.namespace is not None:
            out["namespace"] = self.namespace
        out.update({
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.snapshot(ps)
                           for k, h in sorted(self.hists.items())},
        })
        return out


class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, n: Number = 1) -> None:
        pass

    def set_total(self, total: Number) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v: Number) -> None:
        pass


class _NullHist(Histogram):
    __slots__ = ()

    def observe(self, v: Number) -> None:
        pass


def _null_counter() -> Counter:
    if MetricsBus._NULL_COUNTER is None:
        MetricsBus._NULL_COUNTER = _NullCounter()
    return MetricsBus._NULL_COUNTER


def _null_gauge() -> Gauge:
    if MetricsBus._NULL_GAUGE is None:
        MetricsBus._NULL_GAUGE = _NullGauge()
    return MetricsBus._NULL_GAUGE


def _null_hist() -> Histogram:
    if MetricsBus._NULL_HIST is None:
        MetricsBus._NULL_HIST = _NullHist()
    return MetricsBus._NULL_HIST
