"""Serving executor: model steps, device-side sampling, host↔device moves.

Counterpart of ``repro/serve/executor.py`` on the chunked paged path at
tp = 1. Everything that touches the device lives here:

  * **Token selection runs on the device.** Both regions return sampled
    token ids (greedy argmax), never logits, so the [vocab]-sized
    activations never leave the card.
  * **One device→host transfer per iteration.** The scheduler collects the
    iteration's id tensors and materialises them with one
    :meth:`Executor.fetch_token_ids` call; ``stats["token_fetches"]`` counts
    every call. No other code on the path reads a device value on the host.
  * **Host→device moves are non-blocking.** :meth:`Executor.to_device` packs
    the small int32 host arrays of a dispatch (tokens, page tables,
    lengths) into one pinned buffer and copies it with
    ``non_blocking=True``: a pageable copy would wait on the stream and
    hide the overlap of the scheduler's next iteration with this one's
    device step. PyTorch's pinned-memory cache keeps each buffer until its
    copy has run, so a buffer is never rewritten under a pending copy.

The executor owns no scheduling state and no page accounting; pages are
updated in place by the steps and handed back to the caller.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.offload import TargetRegion
from repro_torch.models import transformer
from repro_torch.serve import paged_step, trace


class Executor:
    """Paged decode / prefill-chunk dispatch for one Engine.

    ``model`` is cast once to the config's compute dtype and must already
    live on ``device``.
    """

    def __init__(self, cfg: transformer.ModelConfig,
                 model: transformer.Transformer, *, page_tokens: int = 16,
                 device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(dtype=cfg.compute_dtype)
        self.page_tokens = page_tokens
        self.tp = 1
        self.stats = {"token_fetches": 0, "tokens_fetched": 0}
        self.bus = None
        self.tracer = trace.null_tracer()
        self._inflight: List[Tuple[str, float]] = []
        decode = paged_step.make_paged_decode_step(cfg, page_tokens)
        prefill = paged_step.make_paged_prefill_chunk_step(cfg, page_tokens)

        def sampled_decode(model, tokens, pages, page_table, lengths, active):
            logits, pages = decode(model, tokens, pages, page_table, lengths,
                                   active)
            return logits.argmax(dim=-1).to(torch.int32), pages

        def sampled_chunk(model, tokens, pages, table_row, start):
            logits, pages = prefill(model, tokens, pages, table_row, start)
            return logits[0].argmax().to(torch.int32), pages

        self._decode = TargetRegion(sampled_decode, name="paged_decode")
        self._prefill_chunk = TargetRegion(sampled_chunk,
                                           name="paged_prefill_chunk")

    # -- host → device -------------------------------------------------------
    def to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Copy int32 host arrays to the device in one non-blocking transfer
        through a pinned buffer; returns one device tensor per input, shaped
        as the input."""
        flats = [np.ascontiguousarray(a, dtype=np.int32).reshape(-1)
                 for a in arrays]
        host = torch.from_numpy(np.concatenate(flats))
        if self.device.type == "cuda":
            dev = host.pin_memory().to(self.device, non_blocking=True)
        else:
            dev = host.to(self.device)
        out, off = [], 0
        for a, f in zip(arrays, flats):
            out.append(dev[off:off + f.size].view(np.shape(a)))
            off += f.size
        return out

    # -- dispatch (asynchronous on the card — the host continues) ----------
    def _note_dispatch(self, kind: str) -> None:
        """Open a device window, closed when this iteration's ids land in
        ``fetch_token_ids``."""
        if self.tracer.enabled:
            self._inflight.append((kind, self.tracer.now()))
        self.tracer.device_dispatch()

    def decode_paged(self, tokens, pages, page_table, lengths, active):
        with self.tracer.span("dispatch", kind="decode_paged"):
            out = self._decode(self.model, tokens, pages, page_table,
                               lengths, active)
            self._note_dispatch("decode_paged")
            return out

    def prefill_chunk(self, tokens, pages, table_row, start: int):
        with self.tracer.span("dispatch", kind="prefill_chunk"):
            out = self._prefill_chunk(self.model, tokens, pages, table_row,
                                      start)
            self._note_dispatch("prefill_chunk")
            return out

    def bind_metrics(self, bus) -> None:
        """Attach the engine's MetricsBus (observe-only)."""
        self.bus = bus

    def bind_tracer(self, tracer) -> None:
        """Attach the engine's Tracer (observe-only)."""
        self.tracer = tracer

    # -- the one device→host transfer --------------------------------------
    def fetch_token_ids(self, arrays: Sequence[torch.Tensor]
                        ) -> List[np.ndarray]:
        """Materialise this iteration's sampled ids in ONE transfer: scalars
        (chunk-completion ids) and [B] vectors (a decode batch) are joined on
        the device and copied to the host once. Returns one host array per
        input, in order."""
        flats = [a.reshape(-1) for a in arrays]
        joined = flats[0] if len(flats) == 1 else torch.cat(flats)
        self.stats["token_fetches"] += 1
        with self.tracer.span("fetch_tokens", arrays=len(arrays)):
            host = joined.cpu().numpy()
        self.tracer.device_landed()
        if self._inflight:
            t_end = self.tracer.now()
            for kind, t_begin in self._inflight:
                self.tracer.async_span("device", "device_step", t_begin,
                                       t_end, kind=kind)
            self._inflight.clear()
        self.stats["tokens_fetched"] += int(host.size)
        if self.bus is not None:
            self.bus.set_total("token_fetches", self.stats["token_fetches"])
            self.bus.set_total("tokens_fetched", self.stats["tokens_fetched"])
        out, off = [], 0
        for f in flats:
            out.append(host[off:off + f.numel()])
            off += f.numel()
        return out
