"""hero_perf: uniform performance counters (HEROv2 §2.4) and the roofline.

Counterpart of ``repro/core/perf.py``. The paper's dynamically assigned
counters (``hero_perf_alloc(event)``, ``hero_perf_continue_all``,
``hero_perf_pause_all``) behind one interface, :class:`PerfSession`, with
three sources:

  * WALL_NS — the host's monotonic clock (eager runs; :func:`timeit`
    synchronises the device around the calls it times);
  * HLO_FLOPS / HLO_BYTES — a traced pass of a step (:class:`TraceCount`:
    ``torch.utils.flop_counter.FlopCounterMode`` over the ATen ops, the
    kernels' own counts beside it, and the bytes every ATen op reads and
    writes as issued, unfused); the counterpart of XLA's cost analysis;
  * COLL_BYTES — the collectives the port's own code issued in that pass,
    as records of kind, result bytes and group size
    (parallel/sharding.py records them on an abstract mesh), through
    :func:`collective_bytes`'s ring model; the counterpart of the
    reference's HLO-text parser.

:class:`Roofline` is the three-term roofline (compute, memory, collective
seconds) on the card's datasheet peaks (:data:`H100`). A kernel wrapper
that launches a hand-written kernel reports the FLOPs of that launch with
:func:`add_kernel_flops` (the ATen dispatcher does not see a ``ctypes``
launch), counted as its plain version's matrix products count them, so a
pass on the card and the same pass on ``meta`` count the same work.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass(frozen=True)
class Chip:
    """One card's peaks for the roofline: dense bf16 FLOP/s, device-memory
    bytes/s, and the link rate the collective term charges per card."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    sms: int = 132      # streaming multiprocessors (a kernel's split plan)


# NVIDIA's datasheet peaks for the H100 SXM5 80GB HBM3 at its 700 W limit
# (not measured here). The production meshes' groups of 16 ranks span more
# than one node of 8 cards, so the collective term charges the inter-node
# link: NDR InfiniBand, 400 Gb/s a GPU = 50e9 B/s. NVLink inside a node
# (450 GB/s a direction) is faster and is not charged.
H100 = Chip("H100 SXM5 80GB HBM3, 700 W (datasheet peaks)",
            peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as issued: ``kind`` (one of :data:`COLLECTIVE_OPS`),
    its result's bytes on this rank (the gathered whole for an all-gather,
    the scattered shard for a reduce-scatter) and its group's size."""
    kind: str
    nbytes: int
    group: int


_RING = {"all-gather": lambda g: (g - 1) / g,
         "all-reduce": lambda g: 2 * (g - 1) / g,
         "reduce-scatter": lambda g: float(g - 1),
         "all-to-all": lambda g: (g - 1) / g,
         "collective-permute": lambda g: 1.0}


def collective_bytes(records: Iterable[Collective]) -> Dict[str, float]:
    """Per-RANK link bytes of ``records`` (the reference's ring model on
    each result's bytes and group size g):
      all-gather       (g−1)/g · result          (result = gathered shape)
      all-reduce       2·(g−1)/g · result
      reduce-scatter   (g−1) · result            (result = scattered shard)
      all-to-all       (g−1)/g · result
      collective-permute  1 · result
    Returns bytes per kind, ``total`` and ``counts`` (per kind); multiply
    by the chip count for the whole-system number :class:`Roofline`
    takes."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_OPS}
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
    for r in records:
        if r.kind not in _RING:
            raise ValueError(f"unknown collective {r.kind!r}")
        out[r.kind] += r.nbytes * _RING[r.kind](max(1, r.group))
        counts[r.kind] += 1
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    out["counts"] = counts  # type: ignore[assignment]
    return out


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one (arch × shape × mesh) cell on ``chip``.
    ``coll_bytes`` None: the collective term is unknown (a path the port
    lacks); ``dominant`` and ``bound_s`` then take the other two."""
    flops: float              # whole-step flops (all devices)
    hbm_bytes: float          # whole-step device-memory bytes
    coll_bytes: Optional[float]   # whole-step collective link bytes
    chips: int
    model_flops: float = 0.0  # (6 | 2)·N·D (useful flops)
    chip: Chip = H100

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.chip.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.chip.hbm_bw)

    @property
    def collective_s(self) -> Optional[float]:
        if self.coll_bytes is None:
            return None
        return self.coll_bytes / (self.chips * self.chip.link_bw)

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound: useful flops over what the dominant
        term allows."""
        if self.bound_s == 0:
            return 0.0
        return self.model_flops / (self.chips * self.chip.peak_flops
                                   * self.bound_s)

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# --------------------------------------------------------------------------
# counting a traced pass
# --------------------------------------------------------------------------
class _Active(threading.local):
    def __init__(self):
        self.counts: List["TraceCount"] = []


_ACTIVE = _Active()


def add_kernel_flops(name: str, flops: float) -> None:
    """A hand-written kernel's launch of ``flops`` FLOPs, added to every
    :class:`TraceCount` open in this thread (none: nothing happens)."""
    for c in _ACTIVE.counts:
        c.kernel_flops[name] = c.kernel_flops.get(name, 0.0) + flops


def add_kernel_scratch(name: str, nbytes: int) -> None:
    """A hand-written kernel's launch that allocates ``nbytes`` of device
    scratch for itself alone (a ``meta`` pass does not allocate it): every
    :class:`TraceCount` open in this thread records it by name and takes
    the bytes alive at the launch plus the scratch as a candidate peak
    (``scratch_peak_bytes``)."""
    for c in _ACTIVE.counts:
        c.kernel_scratch[name] = max(c.kernel_scratch.get(name, 0), nbytes)
        c.scratch_peak_bytes = max(c.scratch_peak_bytes,
                                   c._bytes.live + nbytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every ATen op's tensor inputs and outputs (views
    and metadata ops move none), and follows the storages the ops create:
    ``live`` bytes now, ``peak`` the most at once. A storage is counted
    when an op first returns it, unless it is one of the op's inputs'
    (a view or an in-place result), and uncounted when its last tensor
    dies (a storage's Python object lives as long as the storage does, so
    ``weakref.finalize`` on it fires then)."""

    def __init__(self):
        super().__init__()
        self.bytes = self.live = self.peak = 0
        self._counted: set = set()

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._counted.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False):
            return out
        ins = tree_leaves((args, kwargs or {}))
        self.bytes += sum(_nbytes(t) for t in ins + tree_leaves(out))
        seen = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if id(st) in self._counted:
                continue
            if seen is None:
                seen = {id(a.untyped_storage()) for a in ins
                        if isinstance(a, torch.Tensor)}
            if id(st) in seen:
                continue
            n = st.nbytes()
            self._counted.add(id(st))
            weakref.finalize(st, self._free, id(st), n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


class TraceCount:
    """Counts a pass: ``with TraceCount() as c: step(...)``; then
    ``c.flops`` (FlopCounterMode's ATen FLOPs plus ``kernel_flops``, the
    hand-written kernels' own counts by name), ``c.bytes`` (every ATen
    op's inputs and outputs, unfused) and ``c.peak_bytes`` /
    ``c.end_bytes`` (the storages the pass's ATen ops created: the most
    alive at once, and those alive at its end). A kernel launched on the
    card is not seen; its plain version on ``meta`` is, unless its wrapper
    reports the launch instead (:func:`add_kernel_flops`,
    :func:`add_kernel_scratch`: ``c.kernel_scratch``, its largest scratch
    by name, and ``c.scratch_peak_bytes``, the most bytes alive at a
    launch with its scratch)."""

    def __init__(self):
        self.kernel_flops: Dict[str, float] = {}
        self.kernel_scratch: Dict[str, int] = {}
        self.aten_flops = 0
        self.bytes = self.peak_bytes = self.end_bytes = 0
        self.scratch_peak_bytes = 0
        self._flop = self._bytes = None

    def __enter__(self) -> "TraceCount":
        self._flop = FlopCounterMode(display=False)
        self._bytes = _BytesMode()
        self._flop.__enter__()
        self._bytes.__enter__()
        _ACTIVE.counts.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _ACTIVE.counts.remove(self)
        self._bytes.__exit__(*exc)
        self._flop.__exit__(*exc)
        self.aten_flops = self._flop.get_total_flops()
        self.bytes = self._bytes.bytes
        self.peak_bytes, self.end_bytes = self._bytes.peak, self._bytes.live
        return False

    @property
    def flops(self) -> float:
        return float(self.aten_flops + sum(self.kernel_flops.values()))


# --------------------------------------------------------------------------
# the hero_perf_* counter interface (paper §2.4 names)
# --------------------------------------------------------------------------
EVENTS = ("WALL_NS", "HLO_FLOPS", "HLO_BYTES", "COLL_BYTES", "DMA_BURSTS")


@dataclasses.dataclass
class _Counter:
    event: str
    value: float = 0.0
    running: bool = False
    _t0: float = 0.0


class PerfSession:
    """Allocatable counters; WALL_NS counters really run, the traced ones
    are filled from a traced pass via :meth:`attach_trace`."""

    def __init__(self, max_counters: int = 8):
        self.max = max_counters
        self._counters: List[_Counter] = []

    def hero_perf_alloc(self, event: str) -> int:
        if event not in EVENTS:
            raise ValueError(f"unsupported event {event}")  # paper: returns error
        if len(self._counters) >= self.max:
            raise RuntimeError("hardware counters exhausted")  # paper semantics
        self._counters.append(_Counter(event))
        return len(self._counters) - 1

    def hero_perf_continue_all(self) -> None:
        now = time.perf_counter_ns()
        for c in self._counters:
            if c.event == "WALL_NS" and not c.running:
                c.running, c._t0 = True, now

    def hero_perf_pause_all(self) -> None:
        now = time.perf_counter_ns()
        for c in self._counters:
            if c.event == "WALL_NS" and c.running:
                c.value += now - c._t0
                c.running = False

    def hero_perf_read(self, counter: int) -> float:
        return self._counters[counter].value

    def attach_trace(self, count: TraceCount,
                     collectives: Sequence[Collective] = ()) -> None:
        """The counterpart of the reference's ``attach_compiled``: FLOPs and
        bytes from a traced pass's :class:`TraceCount`, collective link
        bytes from the collectives it issued."""
        coll = collective_bytes(collectives)
        for c in self._counters:
            if c.event == "HLO_FLOPS":
                c.value = count.flops
            elif c.event == "HLO_BYTES":
                c.value = count.bytes
            elif c.event == "COLL_BYTES":
                c.value = coll["total"]

    def attach_plan(self, plan) -> None:
        for c in self._counters:
            if c.event == "DMA_BURSTS":
                c.value = plan.dma_bursts


def _devices(args) -> Tuple[torch.device, ...]:
    return tuple({t.device for t in tree_leaves(args)
                  if isinstance(t, torch.Tensor) and t.device.type == "cuda"})


def timeit(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall time (s) of ``fn(*args)``, each call followed by a
    synchronise of the CUDA devices its tensor arguments lie on."""
    devs = _devices(args)

    def sync():
        for d in devs:
            torch.cuda.synchronize(d)

    for _ in range(warmup):
        fn(*args)
        sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]
