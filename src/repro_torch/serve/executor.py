"""Serving executor: model steps, device-side sampling, host↔device moves, tp.

Counterpart of ``repro/serve/executor.py``. Everything that
touches the device lives here: the paged regions (a decode step, a prompt
chunk) and the dense ones (a B = 1 prefill into a page-padded cache for
the monolithic paged engine, a decode step and a one-slot prefill over the
dense engine's slot caches, models/transformer.py ``forward``). Under a
MoE the tokens of one call share expert capacity, so each region routes
exactly the tokens the reference's does: every slot's row of a decode
step, a chunk's C tokens, and every slot's row of a dense prefill.

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
  * **Tensor parallelism** (``tp > 1``, the paged steps only). The
    reference is one controller running its paged steps under
    ``shard_map``; here each of ``tp`` processes runs one executor (and the
    same scheduler over the same requests), over the group of
    parallel/sharding.py. KV pages shard along their kv-head axis
    (serve/kvcache.py); weights, tokens, page tables and every host-side
    structure are whole on each rank, and the gathered attention heads make
    every rank sample the same ids, which alone drive the schedulers. The
    ranks' host state must therefore stay equal: with ``check_ranks`` the
    executor gathers a hash of the page tables after every iteration and
    raises when the ranks differ (:meth:`Executor.check_ranks`, a debug
    check the tests turn on). The schedulers' clock is one too: each read
    is rank 0's, broadcast over a gloo group of the same ranks
    (:meth:`Executor.read_clock`), a host value that never waits on the
    device stream; ``stats["clock_reads"]`` counts them, and the rank
    check hashes the count, so a rank whose reads fall out of step is
    named at the next check.

The executor owns no scheduling state and no page accounting; pages are
updated in place by the steps and handed back to the caller.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.offload import TargetRegion
from repro_torch.models import transformer
from repro_torch.parallel import sharding
from repro_torch.serve import paged_step, trace


class Executor:
    """Paged and dense step dispatch for one Engine.

    ``model`` is cast once to the config's compute dtype and must already
    live on ``device``. ``tp`` > 1 shards the paged steps' kv heads over
    the process group of that many ranks (``paged`` must be set: the dense
    slot caches are not head-sharded); ``self.rank`` is this process's
    place in it. ``check_ranks`` turns :meth:`check_ranks` on.
    """

    def __init__(self, cfg: transformer.ModelConfig,
                 model: transformer.Transformer, *, page_tokens: int = 16,
                 device="cpu", paged: bool = True, tp: int = 1,
                 check_ranks: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.page_tokens = page_tokens
        self.tp = int(tp)
        if self.tp > 1 and not paged:
            raise ValueError("tensor parallelism requires the paged serving "
                             "path (dense slot caches are not head-sharded)")
        if self.tp > 1 and cfg.n_kv % self.tp != 0:
            raise ValueError(
                f"tp={self.tp} must divide the kv-head count ({cfg.n_kv}): "
                "KV pages shard along the kv-head axis")
        self.group = sharding.tp_group(self.tp)
        self.rank = sharding.rank_of(self.group)
        # the clock's readings are host values: broadcast over gloo (a CPU
        # tensor on an NCCL group would fail), a group of their own
        self.host_group = sharding.host_group() if self.tp > 1 else None
        self.check_ranks_on = check_ranks and self.group is not None
        self.model = model.to(dtype=cfg.compute_dtype)
        self.stats = {"token_fetches": 0, "tokens_fetched": 0,
                      "rank_checks": 0, "clock_reads": 0}
        self.bus = None
        self.tracer = trace.null_tracer()
        self._inflight: List[Tuple[str, float]] = []
        coupled = transformer.couples_rows(cfg)
        decode = paged_step.make_paged_decode_step(cfg, page_tokens,
                                                   self.group)
        prefill = paged_step.make_paged_prefill_chunk_step(cfg, page_tokens,
                                                           self.group)

        def sampled_decode(model, tokens, pages, page_table, lengths, active):
            logits, pages = decode(model, tokens, pages, page_table, lengths,
                                   active)
            return logits.argmax(dim=-1).to(torch.int32), pages

        def sampled_chunk(model, tokens, pages, table_row, start):
            logits, pages = prefill(model, tokens, pages, table_row, start)
            return logits[0].argmax().to(torch.int32), pages

        def sampled_prefill_dense(model, tokens, caches):
            x = transformer.hidden(model, tokens, caches, 0, "prefill")
            return transformer.logits(model, x[:, -1:])[0, -1].argmax().to(
                torch.int32), caches

        def sampled_decode_dense(model, tokens, caches, cache_pos):
            x = transformer.hidden(model, tokens, caches, cache_pos, "decode")
            return transformer.logits(model, x)[:, -1].argmax(dim=-1).to(
                torch.int32), caches

        def sampled_prefill_slot(model, tokens, caches, slot, length):
            # The reference runs every slot's row (the others token 0) and
            # keeps the slot's. Without a MoE the rows are independent, so
            # only the slot's row runs, its views writing into the slot's
            # caches in place. A MoE's rows compete for expert capacity, so
            # there every row runs, as in the reference, over scratch
            # caches of L rows (prefill attends only the new keys), and the
            # slot's rows are copied into its caches.
            if not coupled:
                rows = [tuple({n: a[:, slot:slot + 1] for n, a in kv.items()}
                              for kv in per_pos) for per_pos in caches]
                x = transformer.hidden(model, tokens, rows, 0, "prefill")
                return transformer.logits(model, x[:, length - 1:length])[
                    0, 0].argmax().to(torch.int32), caches
            # scratch as CachePool builds its caches (init_caches' default
            # dtype), one row a slot (axis 1 of every leaf, whatever its
            # kind); a sequence-indexed leaf's first rows land (as many as
            # the scratch holds, on the axis its layer kind gives), a
            # state leaf whole
            B = next(iter(caches[0][0].values())).shape[1]
            L = tokens.shape[1]
            every = tokens.new_zeros((B, L))
            every[slot] = tokens[0]
            scratch = transformer.init_caches(cfg, B, L, device=self.device)
            x = transformer.hidden(model, every, scratch, 0, "prefill")
            for (pattern, _), per_pos, new_pos in zip(cfg.groups, caches,
                                                      scratch):
                for kind, leaves, new in zip(pattern, per_pos, new_pos):
                    axis = transformer.cache_seq_axis(
                        transformer.parse_kind(kind)[0])
                    for n, a in leaves.items():
                        rows = a[:, slot]             # the batch axis goes
                        if axis is not None:
                            rows = rows.narrow(axis - 1, 0,
                                               new[n].shape[axis])
                        rows.copy_(new[n][:, slot])
            return transformer.logits(model, x[slot:slot + 1,
                                               length - 1:length])[
                0, 0].argmax().to(torch.int32), caches

        # serving builds no autograd graph, even over a model that trained
        serve = torch.no_grad()
        self._decode = TargetRegion(serve(sampled_decode),
                                    name="paged_decode")
        self._prefill_chunk = TargetRegion(serve(sampled_chunk),
                                           name="paged_prefill_chunk")
        self._prefill_dense = TargetRegion(serve(sampled_prefill_dense),
                                           name="paged_prefill")
        self._decode_dense = TargetRegion(serve(sampled_decode_dense),
                                          name="dense_decode")
        self._prefill_slot = TargetRegion(serve(sampled_prefill_slot),
                                          name="dense_prefill_slot")

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
        if self.tracer.enabled:      # a span: this rank's own clock
            self._inflight.append((kind, self.tracer.clock()))
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

    def prefill_dense(self, tokens, caches):
        """B = 1 prefill of a whole prompt ([1, L]) into dense ``caches``
        (the monolithic paged engine's; the pool scatters them into
        pages). Returns (sampled id, caches)."""
        with self.tracer.span("dispatch", kind="prefill_dense"):
            out = self._prefill_dense(self.model, tokens, caches)
            self._note_dispatch("prefill_dense")
            return out

    def decode_dense(self, tokens, caches, cache_pos):
        """One decode step of every slot ([B, 1] tokens) at its own position
        ``cache_pos`` ([B] int tensor). Returns ([B] sampled ids, caches)."""
        with self.tracer.span("dispatch", kind="decode_dense"):
            out = self._decode_dense(self.model, tokens, caches, cache_pos)
            self._note_dispatch("decode_dense")
            return out

    def prefill_slot(self, tokens, caches, slot: int, length: int):
        """Prefill one slot's prompt ([1, L]) into its rows of the dense
        slot caches. Returns (sampled id, caches)."""
        with self.tracer.span("dispatch", kind="prefill_slot"):
            out = self._prefill_slot(self.model, tokens, caches, slot, length)
            self._note_dispatch("prefill_slot")
            return out

    def read_clock(self, clock) -> float:
        """Rank 0's reading of ``clock``, broadcast to every rank over the
        host group (the others do not read theirs); counted in
        ``stats["clock_reads"]``. Every rank must call it at the same
        points: a read one rank makes alone waits until the group's
        timeout and raises."""
        t = torch.tensor([clock() if self.rank == 0 else 0.0],
                         dtype=torch.float64)
        dist.broadcast(t, src=0, group=self.host_group)
        self.stats["clock_reads"] += 1
        return float(t[0])

    def check_ranks(self, pool) -> None:
        """The tp ranks' host state is equal, or raise: every rank hashes
        its page tables, slot lengths, free-page count and count of clock
        reads, and the hashes are gathered (one collective, which waits for
        the device). No-op unless ``check_ranks`` was asked for under a
        process group."""
        if not self.check_ranks_on:
            return
        h = hashlib.blake2b(digest_size=8)
        for a in (pool.device_page_tables(), pool.lengths, pool.seq_ids,
                  np.array([pool.alloc.free_pages,
                            self.stats["clock_reads"]])):
            h.update(np.ascontiguousarray(a, dtype=np.int64).tobytes())
        mine = torch.tensor([int.from_bytes(h.digest(), "little",
                                            signed=True)],
                            dtype=torch.int64, device=self.device)
        every = sharding.all_gather_cat(mine, self.group, 0).tolist()
        self.stats["rank_checks"] += 1
        if len(set(every)) != 1:
            raise RuntimeError(
                f"tp ranks diverged at check {self.stats['rank_checks']}: "
                f"page-table hashes by rank {every}")

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
            t_end = self.tracer.clock()
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
