"""hero_memcpy, host half: copies between host DRAM and the card (HEROv2 §2.4).

Counterpart of the host-level functions of ``repro/core/dma.py``: the
paper's DMA API along direction (host2dev / dev2host) and synchronicity
(blocking / ``_async`` + wait). On the card:

* **dev→host** (``hero_memcpy_dev2host_async``). The module's copy stream
  (one per device, :func:`copy_stream`) waits for the work queued so far on
  the current stream, then copies the source into a freshly allocated
  *pinned* host tensor with ``non_blocking=True`` and records an event.
  ``src.record_stream(copy stream)`` keeps the caching allocator from
  handing the source's memory to a later allocation of the current stream
  while the copy still reads it. ``wait()`` synchronises the event: the
  host needs the bytes.
* **host→dev** (``hero_memcpy_host2dev_async``). The source must be pinned
  (a pageable copy would run synchronously and hide every overlap). The
  destination is allocated on the copy stream and copied there; since the
  consumer is the current stream, ``dst.record_stream(current)`` keeps its
  memory from being reused by the copy stream while the consumer still
  reads it. ``wait()`` makes the *current* stream wait on the copy's event
  (the CUDA form of JAX's ``block_until_ready`` for a consumer on the
  device); the host does not block.
* On CPU tensors the same functions make plain copies.

The pinned host buffers stay alive until their copies end without help:
PyTorch's host allocator records an event for every non-blocking copy from
or to pinned memory and reuses the block only after it.

Every handle carries timing events on the copy stream (``start``, ``done``)
for :func:`device_window_ms`, and issue / completion stamps on its own
injected clock (``t_start`` / ``t_done``, observational only) for the serve
tracer's ``dma`` track. The in-kernel half of the reference module
(``copy_async``, ``hero_memcpy2d``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import torch


@dataclasses.dataclass
class TransferHandle:
    """The paper's unique transfer identifier for the ``_async`` variants.

    ``wait()`` is idempotent: it returns the same ``value`` every time and
    stamps ``t_done`` once. ``nbytes`` is the transfer's size for the swap
    tier's traffic counters. ``to_device`` marks a host→dev copy, whose
    wait orders the current stream after the copy instead of blocking the
    host (its ``t_done`` is then the time of that ordering). ``start`` /
    ``done`` are the copy stream's timing events (None on the CPU)."""
    value: torch.Tensor
    _id: int
    nbytes: int = 0
    t_start: float = 0.0
    t_done: float = 0.0
    clock: Callable[[], float] = time.perf_counter
    to_device: bool = False
    start: Optional[torch.cuda.Event] = None
    done: Optional[torch.cuda.Event] = None

    def wait(self) -> torch.Tensor:
        if self.done is not None:
            if self.to_device:
                torch.cuda.current_stream(self.value.device).wait_event(
                    self.done)
            else:
                self.done.synchronize()
        if self.t_done == 0.0:
            self.t_done = self.clock()
        return self.value


_NEXT_ID = [0]
_COPY_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def copy_stream(device) -> torch.cuda.Stream:
    """The side stream that carries every host↔device copy of ``device``,
    made on first use."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = _COPY_STREAMS.get(device)
    if stream is None:
        stream = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _handle(value: torch.Tensor, t_start: float,
            clock: Callable[[], float], **events) -> TransferHandle:
    _NEXT_ID[0] += 1
    return TransferHandle(value, _NEXT_ID[0],
                          value.numel() * value.element_size(),
                          t_start=t_start, clock=clock, **events)


def _on_copy_stream(device, empty: Callable[[], torch.Tensor],
                    src: torch.Tensor):
    """Allocate the destination (``empty()``, with the copy stream current)
    and copy ``src`` into it on the copy stream, after the work already
    queued on the current stream; the timing events bracket the copy
    alone."""
    stream = copy_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    start = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        dst = empty()
        start.record(stream)
        dst.copy_(src, non_blocking=True)
        done.record(stream)
    return dst, start, done


def hero_memcpy_dev2host_async(src: torch.Tensor,
                               clock: Optional[Callable[[], float]] = None,
                               ) -> TransferHandle:
    """Start a copy of ``src`` to host memory (pinned on the card); the
    handle's ``value`` holds the bytes once ``wait()`` returns."""
    clk = clock if clock is not None else time.perf_counter
    t0 = clk()
    if src.device.type != "cuda":
        return _handle(src.detach().clone(), t0, clk)

    host, start, done = _on_copy_stream(
        src.device,
        lambda: torch.empty(src.shape, dtype=src.dtype, pin_memory=True), src)
    src.record_stream(copy_stream(src.device))
    return _handle(host, t0, clk, start=start, done=done)


def hero_memcpy_host2dev_async(device, src: torch.Tensor,
                               clock: Optional[Callable[[], float]] = None,
                               ) -> TransferHandle:
    """Start a copy of the host tensor ``src`` to ``device``; on the card
    ``src`` must be pinned. Consumers read ``value`` after ``wait()``."""
    device = torch.device(device)
    clk = clock if clock is not None else time.perf_counter
    t0 = clk()
    if device.type != "cuda":
        return _handle(src.to(device, copy=True), t0, clk, to_device=True)
    if not src.is_pinned():
        raise ValueError("hero_memcpy_host2dev_async: the source must be "
                         "pinned host memory (a pageable copy is "
                         "synchronous)")
    # allocated on the copy stream, read by the current one: recorded there
    dst, start, done = _on_copy_stream(
        device, lambda: torch.empty(src.shape, dtype=src.dtype,
                                    device=device), src)
    dst.record_stream(torch.cuda.current_stream(device))
    return _handle(dst, t0, clk, to_device=True, start=start, done=done)


def hero_memcpy_host2dev(device, src: torch.Tensor) -> torch.Tensor:
    """Blocking host→device copy: returns once the bytes are on ``device``."""
    h = hero_memcpy_host2dev_async(device, src)
    h.wait()
    if h.done is not None:
        h.done.synchronize()
    return h.value


def hero_memcpy_dev2host(dst: Optional[torch.Tensor],
                         src: torch.Tensor) -> torch.Tensor:
    """Blocking device→host copy, into ``dst`` when it is given."""
    host = hero_memcpy_dev2host_async(src).wait()
    if dst is None:
        return host
    dst.copy_(host)
    return dst


def hero_memcpy_wait(handle: TransferHandle) -> torch.Tensor:
    """Guarantees the transfer has completed before its data is used."""
    return handle.wait()


def hero_memcpy_wait_all(handles: Sequence[TransferHandle]) -> list:
    """Wait a batch of handles. Every transfer was started before the first
    wait, so the total wait is the slowest transfer, not the sum (the
    double-buffering the swap tier relies on)."""
    return [h.wait() for h in handles]


def device_window_ms(handles: Sequence[TransferHandle]) -> float:
    """Milliseconds on the copy stream from the first handle's start event
    to the last one's done event (the handles of one batch, in issue order,
    after their copies have completed)."""
    return handles[0].start.elapsed_time(handles[-1].done)

