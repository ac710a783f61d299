"""Pipeline parallelism over a mesh axis: the GPipe microbatch schedule.

Counterpart of ``repro/parallel/pipeline.py``. Each rank of the stage axis
holds ``n_layers / S`` contiguous layers of a stack and runs the same
program: M microbatches over S stages take ``M + S − 1`` ticks; at each
tick every stage applies its layers to its input (stage 0 takes microbatch
``min(t, M − 1)``, the reference's re-injection of the last one once all
are in; every other stage the buffer its left neighbour sent), then sends
the result one stage on around the ring (parallel/sharding.py
``ring_shift``, the reference's ``ppermute``); the last stage writes
microbatch ``t − (S − 1)`` of the output, and a masked sum over the stage
ranks leaves the output on every stage. The bubble is ``(S − 1) / (S + M −
1)`` (:func:`bubble_fraction`).

The schedule is the reference's op for op (``where`` on the stage and the
tick, never a branch on the rank), so every rank builds the same graph and
runs the same collectives in the same order, forward and backward. It is
differentiable end to end: the ring carries the cotangents back, the
inputs' gradient is summed over the stages (each rank gets it whole, as
JAX's replicated input gets it) and each stage gets its own layers'.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.parallel import sharding


def gpipe(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          mesh: sharding.Mesh, stage_axis: str, n_layers: int):
    """``apply(stacked_params, xs)`` over ``mesh``'s ``stage_axis``.

    ``stacked_params``: this stage's layers, a tree whose leaves lead with
    a ``n_layers / S`` axis (stage s holds layers ``s·n_layers/S`` onward);
    ``layer_fn(layer_params, x) -> x`` applies one. ``xs``: [M, mb, ...]
    microbatches, the same on every stage. Returns [M, mb, ...] outputs,
    the same on every stage."""
    S = mesh.shape[stage_axis]
    if n_layers % S:
        raise ValueError(f"{n_layers} layers do not split into {S} stages")
    per_stage = n_layers // S
    line = mesh.line(stage_axis)

    def apply_stage(params, x):
        for i in range(per_stage):
            x = layer_fn(tree_lib.tree_map(lambda a: a[i], params), x)
        return x

    def apply(params, xs: torch.Tensor) -> torch.Tensor:
        got = {int(a.shape[0]) for a in tree_lib.leaves(params)}
        if got != {per_stage}:
            raise ValueError(f"a stage holds {per_stage} layers, the "
                             f"params lead with {sorted(got)}")
        M = xs.shape[0]
        stage = line.index
        xs = sharding.copy_to(xs, line)       # stage 0's use; grads summed
        first = torch.tensor(stage == 0, device=xs.device)
        buf = torch.zeros_like(xs[0])
        ys = torch.zeros_like(xs)
        for t in range(M + S - 1):
            x_in = torch.where(first, xs[min(t, M - 1)], buf)
            y = apply_stage(params, x_in)
            buf = sharding.ring_shift(y, line, 1)      # stage s -> s + 1
            emit = t - (S - 1)
            put = ys.index_put((torch.tensor([min(max(emit, 0), M - 1)],
                                             device=xs.device),), y[None])
            ys = torch.where(torch.tensor(stage == S - 1 and emit >= 0,
                                          device=xs.device), put, ys)
        # only the last stage holds the outputs: a masked sum over the
        # stages (a ring move needs unique sources; one to all is not one)
        last = torch.tensor(stage == S - 1, device=xs.device)
        return sharding.reduce_from(torch.where(last, ys,
                                                torch.zeros_like(ys)), line)

    return apply


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble: (S−1)/(S+M−1)."""
    return (n_stages - 1) / (n_stages + n_microbatches - 1)
