"""Offload manager: the request mailbox and the offloaded target region.

Counterpart of ``repro/core/offload.py``. :class:`Mailbox` is copied as it
is: a thread-safe bounded FIFO the scheduler drains. :class:`TargetRegion`
is the offloadable region without ``jit``: PyTorch runs eagerly and its
CUDA launches are already asynchronous, so calling the region is the
offload; the region only counts its calls.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Optional


@dataclasses.dataclass
class OffloadStats:
    n_offloads: int = 0


class TargetRegion:
    """``#pragma omp target`` equivalent: a callable that counts offloads."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "target_region")
        self.stats = OffloadStats()

    def __call__(self, *args, **kwargs):
        """Offload (asynchronous on the card: the host continues)."""
        self.stats.n_offloads += 1
        return self.fn(*args, **kwargs)


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
