"""Serving engine façade: scheduler ∘ cache manager ∘ executor wiring.

Counterpart of ``repro/serve/engine.py``::

    from repro_torch.serve.engine import Engine, EngineConfig
    eng = Engine(cfg, model, config=EngineConfig(
        n_slots=8, max_seq=2048, chunked=True, token_budget=256,
        cache=CacheConfig(page_tokens=16, kv_dtype="int8", prefix=True)))

The reference's keyword form still works and builds the same config::

    eng = Engine(cfg, model, n_slots=4, max_seq=96, device="cpu")

its feature flags (``paged=``, ``tiered=``, ``chunked_prefill=``,
``prefix_cache=``) warn with a ``DeprecationWarning`` naming the config
path, and a keyword beside ``config=`` that differs from its default
raises (it would be ignored).

Three loops, as in the reference: the **dense** engine (the default: no
page pool, one ``[n_slots, max_seq]`` slot cache per layer, a whole prompt
prefilled at admission), the **monolithic paged** engine
(``CacheConfig(paged=True)``: a whole prompt prefilled densely, then
scattered into its pages) and the **chunked** engine (``chunked=True``:
token-budgeted prompt chunks and decode in one step loop).
:meth:`EngineConfig.normalized` resolves what implies what: a prefix layer
implies the chunked loop, the chunked loop a page pool.

``cache`` picks one of eight paged stacks (serve/cache.py): paged or int8
pages, with or without the host-DRAM swap tier (``tiered``: preemption),
with or without the shared-prefix layer. ``tp`` shards the paged steps'
kv heads over that many ranks, one engine a process (serve/executor.py,
parallel/launch.py); every rank's scheduler reads rank 0's clock
(``Tracer.now``, broadcast by the executor), so the ranks decide alike
under an ITL target and deadlines, as the reference's one controller
does. ``policy`` attaches an SLO
:class:`~repro_torch.serve.policy.SchedulerPolicy`. The engine runs on
``cuda`` unless the caller passes ``device="cpu"``; without a card and
without that request it raises instead of falling back to the CPU. A
model with cross-attention or an encoder (llama-3.2-vision-11b,
whisper-medium) is refused, as in the reference: it runs through the
prefill / decode steps (train/step.py). This module owns nothing but the
wiring.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.models import transformer
from repro_torch.serve import trace
from repro_torch.serve.cache import CacheConfig, build_cache_manager
from repro_torch.serve.executor import Executor
from repro_torch.serve.kvcache import CachePool, check_pageable
from repro_torch.serve.metrics import MetricsBus
from repro_torch.serve.policy import PolicyConfig, SchedulerPolicy
from repro_torch.serve.scheduler import Request, Scheduler  # noqa: F401


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when the
    device asked for (or the ``cuda`` default) is not available."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


def check_servable(cfg: transformer.ModelConfig) -> None:
    """Raise unless an engine can serve ``cfg``: a model with cross-
    attention or encoder layers needs encoder input (``extra``) at
    prefill, which no engine takes, the reference's neither (its dense
    prefill and paged pool refuse such a model)."""
    if transformer.has_cross(cfg) or cfg.encoder_groups:
        raise ValueError(
            f"{cfg.name}: its cross-attention / encoder layers need encoder "
            "input (extra), which no serving engine takes; run it through "
            "the prefill / decode steps (repro_torch.train.step."
            "make_prefill_step / make_decode_step)")


_DEPRECATION = (
    "Engine(paged=/tiered=/chunked_prefill=/prefix_cache=) feature flags are "
    "deprecated; pass config=EngineConfig(cache=CacheConfig(...)) instead "
    "(see repro_torch.serve.engine.EngineConfig / "
    "repro_torch.serve.cache.CacheConfig)")

# the `trace: bool` field below shadows the module name inside the class body
_DEFAULT_TRACE_BUFFER = trace.DEFAULT_BUFFER

# the keyword form's defaults (the reference's ``_LEGACY_DEFAULTS``)
_LEGACY_DEFAULTS = dict(
    n_slots=4, max_seq=256, greedy=True, paged=False, page_tokens=16,
    n_pages=None, tiered=False, host_budget_bytes=None, preempt_quantum=1,
    chunked_prefill=False, token_budget=None, prefix_cache=False,
    prefix_cache_pages=None)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Declarative engine configuration (the reference's fields).
    ``greedy`` (default True): sampling is greedy argmax either way; False
    only stops the prefix layer from trusting a cached first token (a
    full-prompt match is trimmed by one position, and a completed prompt
    is not indexed), as in the reference. ``chunked`` selects the
    token-budgeted step loop; without it the engine runs the dense loop,
    or the monolithic paged one when ``cache`` is paged.
    ``preempt_quantum``: decode steps a resident of a tiered stack is
    exempt from preemption. ``overlap`` (default True) runs the overlapped
    step loop of the chunked engine (the other loops are synchronous);
    streams are identical either way. ``metrics`` enables the metrics bus
    (a disabled bus leaves streams unchanged); ``metrics_namespace`` stamps
    its snapshots with a replica's name, so the engines of one fleet
    (serve/router.py) do not collide. ``policy`` builds the SLO policy
    (None: policy-free FIFO). ``trace`` enables the execution tracer
    (``Engine.trace_export``); ``trace_buffer`` bounds its event ring.
    ``clock`` injects the engine's one time source (default
    ``time.perf_counter``): the tracer, every scheduler timestamp and the
    swap copies' stamps read it. ``tp``: the tensor-parallel degree; this
    process is one rank of a group of that many (parallel/sharding.py).
    Under tp > 1 each scheduler timestamp is rank 0's reading of its
    clock, broadcast to the others (spans and swap stamps stay local), so
    a rank's own ``clock`` decides nothing; ``check_ranks`` makes its
    executor hold the ranks' page tables and clock reads equal after every
    iteration (a debug check)."""
    n_slots: int = 4
    max_seq: int = 256
    greedy: bool = True
    chunked: bool = False
    token_budget: Optional[int] = None
    preempt_quantum: int = 1
    overlap: bool = True
    tp: int = 1
    check_ranks: bool = False
    cache: CacheConfig = CacheConfig()
    metrics: bool = True
    metrics_namespace: Optional[str] = None
    policy: Optional[PolicyConfig] = None
    trace: bool = False
    trace_buffer: int = _DEFAULT_TRACE_BUFFER
    clock: Optional[Callable[[], float]] = None

    def normalized(self) -> "EngineConfig":
        """Resolve implied layers once: a prefix layer implies the chunked
        loop (insertion happens at chunk completion); the chunked loop, tp
        > 1, the swap tier and int8 pages imply a page pool; the overlapped
        loop exists on the chunked loop only. Everything below reads the
        resolved ``chunked``, ``cache.paged`` and ``overlap``.

        The reference's ``normalized()`` lets only the chunked loop and tp
        set ``paged``; its ``paged`` property adds the swap tier through
        ``cache.any_paged``, and int8 pages without ``paged=True`` leave its
        engine dense. Here int8 pages imply the pool too (no dense int8
        slot cache exists in either package)."""
        cache = self.cache
        chunked = self.chunked or cache.prefix
        paged = (cache.paged or chunked or self.tp > 1 or cache.tiered
                 or cache.kv_dtype != "compute")
        return dataclasses.replace(
            self, chunked=chunked, overlap=self.overlap and chunked,
            cache=dataclasses.replace(cache, paged=paged))


class Engine:
    """Continuous-batching engine over the port's three serving layers.

    ``model`` is a :class:`~repro_torch.models.transformer.Transformer`; it
    is moved to ``device`` and cast to the compute dtype in place. The
    reference's keyword form (``n_slots=`` ... ``prefix_cache_pages=``)
    maps onto :class:`EngineConfig` and :class:`CacheConfig` as its
    ``_LEGACY_DEFAULTS`` do (see the module docstring).
    """

    def __init__(self, cfg: transformer.ModelConfig,
                 model: transformer.Transformer,
                 n_slots: int = 4, max_seq: int = 256, greedy: bool = True,
                 paged: bool = False, page_tokens: int = 16,
                 n_pages: Optional[int] = None, tiered: bool = False,
                 host_budget_bytes: Optional[int] = None,
                 preempt_quantum: int = 1, chunked_prefill: bool = False,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: Optional[int] = None,
                 config: Optional[EngineConfig] = None, device=None):
        legacy = dict(
            n_slots=n_slots, max_seq=max_seq, greedy=greedy, paged=paged,
            page_tokens=page_tokens, n_pages=n_pages, tiered=tiered,
            host_budget_bytes=host_budget_bytes,
            preempt_quantum=preempt_quantum, chunked_prefill=chunked_prefill,
            token_budget=token_budget, prefix_cache=prefix_cache,
            prefix_cache_pages=prefix_cache_pages)
        if config is not None:
            # config is the whole truth: a keyword beside it would be
            # silently ignored, so refuse it
            stray = {k for k, v in legacy.items()
                     if v != _LEGACY_DEFAULTS[k]}
            if stray:
                raise ValueError(
                    f"Engine: config= was given together with legacy "
                    f"kwargs {sorted(stray)} — fold them into EngineConfig/"
                    "CacheConfig instead (they would be ignored)")
        else:
            if paged or tiered or chunked_prefill or prefix_cache:
                warnings.warn(_DEPRECATION, DeprecationWarning, stacklevel=2)
            config = EngineConfig(
                n_slots=n_slots, max_seq=max_seq, greedy=greedy,
                chunked=chunked_prefill, token_budget=token_budget,
                preempt_quantum=preempt_quantum,
                cache=CacheConfig(
                    paged=paged, page_tokens=page_tokens, n_pages=n_pages,
                    tiered=tiered, host_budget_bytes=host_budget_bytes,
                    prefix=prefix_cache, prefix_pages=prefix_cache_pages))
        check_servable(cfg)
        config = config.normalized()
        if config.cache.paged:    # before a tp executor joins its group
            check_pageable(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.config = config
        self.executor = Executor(cfg, model.to(self.device),
                                 page_tokens=config.cache.page_tokens,
                                 device=self.device,
                                 paged=config.cache.paged, tp=config.tp,
                                 check_ranks=config.check_ranks)
        self.model = self.executor.model
        if config.cache.paged:
            pool = build_cache_manager(cfg, config.cache, config.n_slots,
                                       config.max_seq, device=self.device,
                                       tp=config.tp,
                                       rank=self.executor.rank)
        else:
            pool = CachePool(cfg, config.n_slots, config.max_seq,
                             device=self.device)
        self.bus = MetricsBus(enabled=config.metrics,
                              namespace=config.metrics_namespace)
        self.executor.bind_metrics(self.bus)
        # a real Tracer even when disabled: its clock is the time source
        self.tracer = trace.Tracer(enabled=config.trace, clock=config.clock,
                                   buffer=config.trace_buffer)
        if config.tp > 1:     # every rank's scheduler reads rank 0's clock
            self.tracer.share(self.executor.read_clock)
        self.executor.bind_tracer(self.tracer)
        if config.cache.paged:  # the dense pool has no instrumented work
            pool.bind_tracer(self.tracer)
        policy = None
        if config.policy is not None:
            policy = SchedulerPolicy(config.policy, bus=self.bus)
        self.scheduler = Scheduler(
            cfg, pool, self.executor, n_slots=config.n_slots,
            greedy=config.greedy, paged=config.cache.paged,
            chunked=config.chunked, token_budget=config.token_budget,
            tiered=config.cache.tiered,
            preempt_quantum=config.preempt_quantum, overlap=config.overlap,
            metrics=self.bus, policy=policy, tracer=self.tracer)

    # -- host API (delegates to the scheduler) -----------------------------
    def submit(self, req: Request) -> bool:
        return self.scheduler.submit(req)

    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    def step(self) -> List[Request]:
        return self.scheduler.step()

    def run(self, max_steps: int = 1000) -> List[Request]:
        return self.scheduler.run(max_steps)

    def stats_summary(self) -> Dict[str, Any]:
        return self.scheduler.stats_summary()

    def metrics_snapshot(self, ps=(50, 90, 99)) -> Dict[str, Any]:
        return self.bus.snapshot(ps)

    @property
    def metrics(self) -> MetricsBus:
        return self.bus

    def trace_export(self, path: str) -> str:
        return self.tracer.export(path)

    def trace_summary(self) -> Dict[str, Any]:
        return self.tracer.stall_summary()

    @property
    def shed(self) -> List[Request]:
        """Requests the policy rejected, each with a typed
        :class:`~repro_torch.serve.policy.ShedVerdict` on ``.verdict``."""
        return self.scheduler.shed

    # -- introspection ------------------------------------------------------
    @property
    def pool(self):
        return self.scheduler.pool

    @property
    def stats(self):
        return self.scheduler.stats

    @property
    def mailbox(self):
        return self.scheduler.mailbox

    @property
    def prefix(self):
        """The stack's :class:`~repro_torch.serve.prefix_cache.PrefixCache`,
        or None without a prefix layer."""
        return self.scheduler.prefix

    @property
    def active(self):
        return self.scheduler.active

    @property
    def prefilling(self):
        return self.scheduler.prefilling

    @property
    def prefilled_wait(self):
        return self.scheduler.prefilled_wait

    @property
    def greedy(self):
        return self.scheduler.greedy

    @property
    def paged(self):
        return self.scheduler.paged

    @property
    def tiered(self):
        return self.scheduler.tiered

    @property
    def chunked(self):
        return self.scheduler.chunked

    @property
    def token_budget(self):
        return self.scheduler.token_budget

    @property
    def preempt_quantum(self):
        return self.scheduler.preempt_quantum
