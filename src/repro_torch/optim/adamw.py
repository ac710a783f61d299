"""AdamW with global-norm clipping, as plain functions on tensor trees.

Counterpart of ``repro/optim/adamw.py``: the moments ``m`` / ``v`` are f32
trees shaped as the parameters; the update runs in f32 and is cast back to
each leaf's dtype; clipping scales every gradient by ``min(1, clip_norm /
‖g‖)``; the bias corrections use ``t = step + 1``; the learning rate warms
up linearly, then decays on a cosine to ``min_lr_ratio``; weight decay is
added to the update of every leaf of two or more axes. The port's leaves
are stacked ``[count, ...]`` as the reference's are, so a stacked norm
scale is 2-D and decayed, as there. ``torch.optim.AdamW`` is not used: it
decays every leaf and has no such schedule.

Trees are walked by core/tree.py; a gradient leaf may be None (a leaf the
loss did not reach), which counts as zeros, as JAX's gradient would be.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class Config:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any


def init(params) -> OptState:
    """Zero f32 moments shaped as the leaves of ``params``."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(m=tree_lib.tree_map(z, params),
                    v=tree_lib.tree_map(z, params))


def schedule(step: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Linear warmup, then a cosine decay to ``min_lr_ratio``, in f32 (a
    0-d tensor on ``step``'s device)."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / max(1.0, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ leaf²) in f32, the leaves in tree order."""
    total = None
    for leaf in tree_lib.leaves(tree):
        if leaf is None:
            continue
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def update(grads, opt: OptState, params, step: torch.Tensor, cfg: Config,
           gnorm: Optional[torch.Tensor] = None
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (the new parameter leaves, the new moments, metrics
    ``grad_norm`` and ``lr``). Nothing is written in place; the caller
    copies the new leaves into its parameters (train/step.py). ``gnorm``:
    the gradient's global norm when ``grads`` holds one rank's shards of
    it (train/step.py's FSDP step: the clip needs the norm over every
    shard); :func:`global_norm` of ``grads`` by default."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = schedule(step, cfg)
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)

    def upd(p, g, m, v):
        g32 = torch.zeros_like(m) if g is None else g.float()
        if scale is not None:
            g32 = g32 * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g32
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if p.dim() >= 2:   # decay matrices only (norms / biases exempt)
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_lib.leaves(params), tree_lib.leaves(grads),
        tree_lib.leaves(opt.m), tree_lib.leaves(opt.v))]
    new_p, new_m, new_v = (tree_lib.unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, OptState(new_m, new_v), {"grad_norm": gnorm, "lr": lr}
