"""One schedule through a tensor-parallel engine or fleet on every rank.

Support for tests/test_torch_tp.py, tests/test_torch_router.py and
chip_smoke.py's tp phase; it holds no tests of its own. It imports no JAX,
so neither chip_smoke.py nor the ranks that
``repro_torch.parallel.launch.spawn`` starts with :func:`serve_schedule`
load JAX::

    out = launch.spawn(serve_schedule, 2, (job,), store_dir=tmp,
                       backend="gloo")
    res = replicated(out, ("streams", "stats"))

:func:`serve_schedule` serves one :class:`ServeJob` (model config,
weights, engine config, a schedule of arrivals) through one engine or
fleet on the rank, and returns the streams, the counters and the state of
the drained pool, private state included, for the caller to hold equal
across ranks (:func:`replicated`) and against a reference. On the card,
pass ``devices=("cuda:0", "cuda:1")`` with NCCL, or one card for every
rank with gloo (which stages CUDA tensors through the host).

A schedule may carry deadlines, and the job a clock for each rank: a
:class:`ManualClock` that :func:`drive` sets once an iteration from
``ticks``. Under tp > 1 the ranks' schedulers read rank 0's clock alone
(serve/executor.py ``read_clock``), so a rank's own clock, however
skewed, changes no decision.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class ManualClock:
    """A clock the driver sets: ``clock()`` is ``scale * t + offset`` for
    the last ``t`` given to :meth:`set`. It pickles, so a rank's injected
    clock reaches it through ``launch.spawn``."""

    def __init__(self, scale: float = 1.0, offset: float = 0.0):
        self.scale, self.offset, self.t = float(scale), float(offset), 0.0

    def set(self, t: float) -> None:
        self.t = float(t)

    def __call__(self) -> float:
        return self.scale * self.t + self.offset


@dataclasses.dataclass
class ServeJob:
    """What :func:`serve_schedule` runs on each rank.

    ``weights``: the reference layout as numpy leaves
    (models/convert.py), or an int seed for ``init_model`` with a
    ``torch.Generator`` on the rank's device (every rank draws the same
    weights). ``schedule``: ``(arrival iteration, prompt, max_new)`` per
    request, or ``(arrival iteration, prompt, max_new, priority)``, or
    ``(..., priority, deadline_s)``; ``seq_id`` is its index.
    ``devices[rank]`` is the rank's device (None: the CPU for every rank).
    ``clocks[rank]``: the rank's injected clock (``config.clock``), set to
    ``ticks[it]`` before iteration ``it``'s arrivals (the last tick holds
    after); None: ``config.clock`` on every rank.
    ``replicas`` > 0 serves through a :class:`~repro_torch.serve.router.
    Fleet` of that many engines under ``router`` (drained at the end)."""
    cfg: Any
    weights: Any
    config: Any
    schedule: List[Tuple]
    devices: Optional[Sequence[str]] = None
    replicas: int = 0
    router: str = "prefix"
    max_iters: int = 4000
    clocks: Optional[Sequence[ManualClock]] = None
    ticks: Optional[Sequence[float]] = None


def _model(job: ServeJob, device: torch.device):
    from repro_torch.models import convert, transformer
    if isinstance(job.weights, int):
        gen = torch.Generator(device=device).manual_seed(job.weights)
        return transformer.init_model(job.cfg, gen, device)
    return convert.params_from_numpy(job.weights, job.cfg, device)


def drive(target, job: ServeJob, clock: Optional[ManualClock] = None
          ) -> List[Any]:
    """Feed the schedule into a stepping engine or fleet: each request at
    its arrival iteration, in (arrival, index) order; step until idle.
    ``clock`` is set to ``job.ticks[it]`` before iteration ``it``."""
    from repro_torch.serve.engine import Request
    pending = sorted(enumerate(job.schedule), key=lambda t: (t[1][0], t[0]))
    done, it = [], 0
    while True:
        if clock is not None:
            clock.set(job.ticks[min(it, len(job.ticks) - 1)])
        while pending and pending[0][1][0] <= it:
            sid, (_, prompt, max_new, *rest) = pending.pop(0)
            req = Request(seq_id=sid, prompt=prompt.copy(), max_new=max_new,
                          priority=rest[0] if rest else 0,
                          deadline_s=rest[1] if len(rest) > 1 else None)
            if not target.submit(req):
                raise RuntimeError(f"request {sid} refused at submission")
        if not pending and target.idle:
            return done
        done.extend(target.step())
        it += 1
        if it > job.max_iters:
            raise RuntimeError("the schedule did not drain")


def _scalars(stats: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in stats.items()
            if isinstance(v, (int, float, np.integer, np.floating))}


def _engine_state(eng) -> Dict[str, Any]:
    """The drained engine: its counters and iteration log, the executor's,
    the tracer's stall log, and the pool (leaks, the prefix cache's pages,
    the free count after clearing it, the allocator's audit)."""
    sched, pool = eng.scheduler, eng.pool
    out = {"stats": _scalars(eng.stats),
           "admission_order": list(eng.stats["admission_order"]),
           "bus_counters": dict(eng.metrics_snapshot().get("counters", {})),
           "iter_log": list(eng.stats.get("iter_log", ())),
           "executor": dict(eng.executor.stats),
           "token_budget": sched.token_budget,
           "busy": bool(sched.active or sched.prefilling
                        or sched.prefilled_wait),
           "in_flight": bool(sched._pending_swapins or sched._commit_queue
                             or sched._fetch_queue)}
    if eng.tracer.enabled:
        out["stall_log"] = eng.tracer.stall_log()
        out["histograms"] = sorted(eng.metrics_snapshot()["histograms"])
    if not eng.config.cache.paged:
        return out
    alloc = pool.alloc
    out["pool"] = {
        "seq_pages": {int(k): list(v) for k, v in alloc._seq_pages.items()},
        "seq_ids": pool.seq_ids.tolist(), "n_pages": alloc.n_pages,
        "free_pages": alloc.free_pages, "page_nbytes": pool.page_nbytes(),
        "kv_heads": pool.pages[0][0]["k"].shape[2],
        "reserved": dict(pool._reserved)}
    if hasattr(pool, "cold_seqs"):
        out["pool"].update(cold=pool.cold_seqs(),
                           host_used=pool.host_used_bytes(),
                           l3_in_use=pool.hero.levels[3].in_use())
    if pool.prefix is not None:
        cached = pool.prefix.cached_pages()
        out["pool"].update(
            cached=list(cached), held=pool.prefix.held_pages,
            cached_refcounts=[alloc.refcount(p) for p in cached])
        alloc.audit()
        pool.prefix.clear()
        out["pool"]["free_after_clear"] = alloc.free_pages
    alloc.audit()
    return out


def serve_schedule(rank: int, job: ServeJob) -> Dict[str, Any]:
    """Run ``job`` on this rank (see :class:`ServeJob`); returns the
    greedy streams, the launches of the paged kernels, and the drained
    engine's (or each replica's) state and counters."""
    from repro_torch.kernels.paged_decode_attention import paged_flash_decode
    from repro_torch.kernels.paged_prefill_attention import \
        paged_flash_prefill
    from repro_torch.serve.engine import Engine
    device = torch.device(job.devices[rank] if job.devices else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    model = _model(job, device)
    config, clock = job.config, None
    if job.clocks is not None:
        clock = job.clocks[rank]
        config = dataclasses.replace(config, clock=clock)
    if job.replicas:
        from repro_torch.serve.router import Fleet
        target = Fleet(job.cfg, model, config, replicas=job.replicas,
                       router=job.router, device=device)
    else:
        target = Engine(job.cfg, model, config=config, device=device)
    launches = (paged_flash_decode.launches, paged_flash_prefill.launches)
    t0 = time.perf_counter()
    done = drive(target, job, clock)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out: Dict[str, Any] = {
        "rank": rank, "device": str(device),
        "wall_s": time.perf_counter() - t0,
        "streams": {r.seq_id: list(r.tokens_out) for r in done},
        "launches": {
            "paged_flash_decode": paged_flash_decode.launches - launches[0],
            "paged_flash_prefill":
                paged_flash_prefill.launches - launches[1]}}
    if job.replicas:
        from repro_torch.serve import replica
        out["fleet"] = dict(target.stats)
        out["finished"] = sorted(int(r.seq_id) for r in target.finished)
        out["shed"] = sorted(int(r.seq_id) for r in target.shed)
        out["pending"] = len(target._pending) + len(target._inflight)
        # drain every live replica and step it dead: each one's state
        # after, its allocator audited
        for rep in target.replicas:
            if rep.state == replica.READY:
                target.drain(rep.name)
        target.run(50)
        out["states"] = {rep.name: rep.state for rep in target.replicas}
        out["replicas"] = {rep.name: _engine_state(rep.engine)
                           for rep in target.replicas
                           if rep.engine is not None}
    else:
        out["summary"] = target.stats_summary()
        out["shed"] = [(int(r.seq_id), r.verdict.code) for r in target.shed]
        out.update(_engine_state(target))
    return out


def replicated(results: List[Dict[str, Any]],
               keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Rank 0's result, after checking that every rank returned the same
    value under each of ``keys`` (default: the streams)."""
    keys = keys or ("streams",)
    for r in results[1:]:
        for k in keys:
            if r.get(k) != results[0].get(k):
                raise AssertionError(f"rank {r['rank']} differs from rank 0 "
                                     f"in {k!r}")
    return results[0]
