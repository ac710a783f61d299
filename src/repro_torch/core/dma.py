"""hero_memcpy: the paper's DMA API (HEROv2 §2.4) on the card.

Counterpart of ``repro/core/dma.py``: the paper's DMA API along direction
(host2dev / dev2host), synchronicity (blocking / ``_async`` + wait) and
dimensionality (1-D / 2-D scatter-gather). Between host DRAM and the
card:

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
tracer's ``dma`` track.

Inside the card, the reference's in-kernel half is hand-written CUDA:
``copy_async`` is a ``__device__`` helper (``csrc/hero_dma.cuh``: a TMA
bulk copy from device memory into shared memory on an mbarrier, whose
handle's ``wait()`` waits on the barrier's phase), and
:func:`hero_memcpy2d` launches ``csrc/hero_memcpy2d.cu``, which stages
rows through it. The reference's sequential row loop is the semantics,
overlapping and zero-stride destinations included (the later row wins);
:func:`hero_memcpy2d_plain` walks that loop in PyTorch for CPU and
``meta`` tensors, and :func:`memcpy2d_ref` is the numpy oracle.
``hero_memcpy2d.launches`` counts calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
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



# --------------------------------------------------------------------------
# inside the card: the 2-D scatter-gather copy
# --------------------------------------------------------------------------
def memcpy2d_ref(dst: np.ndarray, src: np.ndarray, rows: int, elems: int,
                 src_stride: int, dst_stride: int, src_off=0,
                 dst_off=0) -> np.ndarray:
    """The numpy oracle (the reference's ``memcpy2d_ref``): a copy of
    ``dst`` after the sequential row loop."""
    dst = np.array(dst)
    for i in range(rows):
        s = src_off + i * src_stride
        d = dst_off + i * dst_stride
        dst[d:d + elems] = src[s:s + elems]
    return dst


def hero_memcpy2d_plain(dst: torch.Tensor, src: torch.Tensor, rows: int,
                        elems: int, src_stride: int, dst_stride: int,
                        src_off: int = 0, dst_off: int = 0) -> torch.Tensor:
    """The reference's row loop in PyTorch, in place on ``dst``."""
    for i in range(rows):
        s = src_off + i * src_stride
        d = dst_off + i * dst_stride
        dst[d:d + elems] = src[s:s + elems]
    return dst


def _check_2d(dst, src, rows, elems, src_stride, dst_stride, src_off,
              dst_off) -> None:
    name = "hero_memcpy2d"
    if dst.dim() != 1 or src.dim() != 1 or not dst.is_contiguous() or \
            not src.is_contiguous():
        raise ValueError(f"{name}: dst and src must be contiguous 1-D "
                         "tensors")
    if dst.dtype != src.dtype or dst.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"{name}: dst and src must share a dtype of 1, 2, 4 "
                        f"or 8 bytes, got {dst.dtype}/{src.dtype}")
    if dst.device != src.device:
        raise ValueError(f"{name}: dst on {dst.device}, src on {src.device}")
    if min(rows, elems, src_stride, dst_stride, src_off, dst_off) < 0:
        raise ValueError(f"{name}: rows, elems, strides and offsets must be "
                         ">= 0")
    if rows and elems and (
            src_off + (rows - 1) * src_stride + elems > src.numel()
            or dst_off + (rows - 1) * dst_stride + elems > dst.numel()):
        raise ValueError(f"{name}: {rows} rows of {elems} run past src "
                         f"({src.numel()}) or dst ({dst.numel()})")
    if dst.device.type != "meta" and dst.numel() and src.numel() and \
            dst.untyped_storage().data_ptr() == \
            src.untyped_storage().data_ptr():
        raise ValueError(f"{name}: src shares its storage with dst")


def hero_memcpy2d(dst: torch.Tensor, src: torch.Tensor, rows: int,
                  elems: int, src_stride: int, dst_stride: int,
                  src_off: int = 0, dst_off: int = 0) -> torch.Tensor:
    """2-D scatter-gather copy (the paper's ``hero_memcpy2d``): ``rows``
    sequences of ``elems`` elements, row i from ``src[src_off + i *
    src_stride:][:elems]`` to ``dst[dst_off + i * dst_stride:][:elems]``, as
    the sequential row loop writes them (a later row wins where rows
    overlap). ``dst`` and ``src``: contiguous 1-D tensors of one dtype of
    1, 2, 4 or 8 bytes, not sharing storage; offsets and strides in
    elements. Writes ``dst`` in place and returns it. CUDA tensors launch
    ``csrc/hero_memcpy2d.cu`` (or raise); CPU and ``meta`` tensors take
    :func:`hero_memcpy2d_plain`."""
    args = (rows, elems, src_stride, dst_stride, src_off, dst_off)
    _check_2d(dst, src, *args)
    if dst.device.type in ("cpu", "meta"):
        return hero_memcpy2d_plain(dst, src, *args)
    if dst.device.type != "cuda":
        raise ValueError(f"hero_memcpy2d: unsupported device {dst.device}")
    from repro_torch.kernels import _build
    lib = _build.load("hero_memcpy2d")
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = lib.hero_memcpy2d(
        ctypes.c_void_p(dst.data_ptr()), ctypes.c_void_p(src.data_ptr()),
        *args, dst.element_size(), ctypes.c_void_p(stream))
    _build.check("hero_memcpy2d", err)
    hero_memcpy2d.launches += 1
    return dst


hero_memcpy2d.launches = 0
