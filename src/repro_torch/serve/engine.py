"""Serving engine façade: scheduler ∘ cache manager ∘ executor wiring.

Counterpart of ``repro/serve/engine.py`` on the chunked paged path::

    from repro_torch.serve.engine import Engine, EngineConfig
    eng = Engine(cfg, model, config=EngineConfig(
        n_slots=8, max_seq=2048, chunked=True, token_budget=256,
        cache=CacheConfig(page_tokens=16)))

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request it raises instead of falling back
to the CPU. This module owns nothing but the wiring.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.models import transformer
from repro_torch.serve import trace
from repro_torch.serve.cache import CacheConfig, build_cache_manager
from repro_torch.serve.executor import Executor
from repro_torch.serve.metrics import MetricsBus
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


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Declarative engine configuration (fields as in the reference, for
    the ported path). ``chunked`` must be True: only the chunked paged loop
    is ported. ``overlap`` (default True) runs the overlapped step loop;
    streams are identical either way. ``trace`` enables the execution
    tracer (``Engine.trace_export``)."""
    n_slots: int = 4
    max_seq: int = 256
    chunked: bool = False
    token_budget: Optional[int] = None
    overlap: bool = True
    cache: CacheConfig = CacheConfig()
    trace: bool = False


class Engine:
    """Continuous-batching engine over the port's three serving layers.

    ``model`` is a :class:`~repro_torch.models.transformer.Transformer`; it
    is moved to ``device`` and cast to the compute dtype in place.
    """

    def __init__(self, cfg: transformer.ModelConfig,
                 model: transformer.Transformer,
                 config: Optional[EngineConfig] = None, device=None):
        config = config or EngineConfig()
        if not config.chunked:
            raise NotImplementedError(
                "repro_torch: only the chunked paged engine is ported; the "
                "dense and monolithic paths are ROADMAP queue 1, item 14")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.config = config
        self.executor = Executor(cfg, model.to(self.device),
                                 page_tokens=config.cache.page_tokens,
                                 device=self.device)
        self.model = self.executor.model
        pool = build_cache_manager(cfg, config.cache, config.n_slots,
                                   config.max_seq, device=self.device)
        self.bus = MetricsBus()
        self.executor.bind_metrics(self.bus)
        self.tracer = trace.Tracer(enabled=config.trace)
        self.executor.bind_tracer(self.tracer)
        pool.bind_tracer(self.tracer)
        self.scheduler = Scheduler(
            cfg, pool, self.executor, n_slots=config.n_slots,
            token_budget=config.token_budget, overlap=config.overlap,
            metrics=self.bus, tracer=self.tracer)

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

    def trace_export(self, path: str) -> str:
        return self.tracer.export(path)

    def trace_summary(self) -> Dict[str, Any]:
        return self.tracer.stall_summary()

    # -- introspection ------------------------------------------------------
    @property
    def pool(self):
        return self.scheduler.pool

    @property
    def stats(self):
        return self.scheduler.stats
