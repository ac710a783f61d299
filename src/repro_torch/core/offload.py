"""Offload manager: the request mailbox and the offloaded target region.

Counterpart of ``repro/core/offload.py``. :class:`Mailbox` is copied as it
is: a thread-safe bounded FIFO the scheduler drains. :class:`TargetRegion`
is the offloadable region without ``jit``: PyTorch runs eagerly and its
CUDA launches are already asynchronous, so calling the region is the
offload, and the region counts its calls. :meth:`TargetRegion.trace` is
the counterpart of the reference's ``lower_compile``, the dry run's entry:
it runs the region once on ``meta`` tensors (shapes alone, no memory)
under the counters of core/perf.py and the collective recorder of
parallel/sharding.py, and caches the :class:`Trace` by the arguments'
shapes and dtypes and the active mesh and rules (:func:`_spec_key`).
:func:`target` is the decorator sugar.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import perf
from repro_torch.core import tree as tree_lib


@dataclasses.dataclass
class OffloadStats:
    n_offloads: int = 0
    n_traces: int = 0
    last_trace_s: float = 0.0


@dataclasses.dataclass
class Trace:
    """One traced pass: FLOPs (ATen and the kernels' own, by name), the
    bytes every ATen op read and wrote, the most bytes of the storages it
    created alive at once (``peak_bytes``), the collectives issued (one
    rank's records), the outputs (``meta`` tensors) and the host
    seconds; ``scratch_peak_bytes``, the most bytes alive at a
    hand-written kernel's launch with the scratch it allocates
    (``perf.add_kernel_scratch``)."""
    flops: float
    kernel_flops: Dict[str, float]
    bytes: int
    peak_bytes: int
    collectives: List[perf.Collective]
    outputs: Any
    seconds: float
    scratch_peak_bytes: int = 0


class TargetRegion:
    """``#pragma omp target`` equivalent: a callable that counts offloads
    and traces."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "target_region")
        self.stats = OffloadStats()
        self._traced: Dict[Tuple, Trace] = {}

    def __call__(self, *args, **kwargs):
        """Offload (asynchronous on the card: the host continues)."""
        self.stats.n_offloads += 1
        return self.fn(*args, **kwargs)

    def trace(self, *arg_specs, key: Optional[Tuple] = None,
              **kw_specs) -> Trace:
        """Run the region once on ``arg_specs`` (``meta`` tensors for a dry
        run) and count it; cached by :func:`_spec_key` (or ``key``)."""
        from repro_torch.parallel import sharding
        cache_key = key if key is not None else _spec_key(arg_specs,
                                                          kw_specs)
        hit = self._traced.get(cache_key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        with sharding.record_collectives() as colls, \
                perf.TraceCount() as count:
            out = self.fn(*arg_specs, **kw_specs)
        self.stats.n_traces += 1
        self.stats.last_trace_s = time.perf_counter() - t0
        self._traced[cache_key] = Trace(
            count.flops, dict(count.kernel_flops), count.bytes,
            count.peak_bytes, colls, out, self.stats.last_trace_s,
            count.scratch_peak_bytes)
        return self._traced[cache_key]


def _spec_key(args, kwargs) -> Tuple:
    """The arguments' shapes and dtypes (a module's parameters' too), other
    leaves as they are, with the active mesh and rules."""
    from repro_torch.parallel import sharding

    def k(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype), x.device.type)
        if isinstance(x, torch.nn.Module):
            return tuple((n, tuple(p.shape), str(p.dtype))
                         for n, p in x.named_parameters())
        return x if isinstance(x, (int, float, str, bool, type(None))) \
            else repr(x)
    flat = tuple((p, k(x)) for p, x in tree_lib.paths((args, kwargs)))
    rules = tuple(sorted((n, str(v)) for n, v in
                         sharding.current_rules().items()))
    return flat, repr(sharding.current_mesh()), rules


def target(**kw) -> Callable:
    """Decorator sugar: ``@target(name=...)`` makes a TargetRegion."""
    def deco(fn):
        return TargetRegion(fn, **kw)
    return deco


class Mailbox:
    """Thread-safe bounded FIFO with blocking get — the paper's HW mailbox."""

    def __init__(self, depth: int = 64):
        self._q: "collections.deque" = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.depth = depth

    def put(self, msg) -> bool:
        with self._cv:
            if len(self._q) >= self.depth:
                return False  # paper: mailbox full -> sender retries
            self._q.append(msg)
            self._cv.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            if not self._q:
                return None
            return self._q.popleft()

    def drain(self, max_n: int) -> list:
        """Batch-pop up to max_n requests (serving batcher)."""
        with self._cv:
            out = []
            while self._q and len(out) < max_n:
                out.append(self._q.popleft())
            return out

    def requeue(self, msg) -> None:
        """Push back at the *front* (admission-control refusal keeps FIFO
        order; allowed to exceed depth — the message was already accepted)."""
        with self._cv:
            self._q.appendleft(msg)
            self._cv.notify()

    def __len__(self):
        with self._lock:
            return len(self._q)
