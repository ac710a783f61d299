"""The serving tensor-parallel group.

Counterpart of the serving part of ``repro/parallel/sharding.py``
(``TP_AXIS``, ``tp_mesh``). The reference is one controller over a 1-D
``tp`` mesh of devices, with ``shard_map`` placing each kv-head shard. The
port runs one process a rank instead (parallel/launch.py starts them): each
rank runs the same scheduler over the same requests, holds its own shard of
the KV pages, and meets the others in one collective a layer, the
``all_gather`` of attention heads before ``wo`` (:func:`all_gather_cat`).
On the card rank r owns ``cuda:r`` and the group talks NCCL; on the CPU it
talks gloo.

Only what serving's tp needs is here: no fsdp, no other mesh axes.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

def init_tp(rank: int, tp: int, store_path: str, backend: str,
            timeout_s: float = 120.0) -> None:
    """Join this process to a ``tp``-rank group through a ``FileStore`` at
    ``store_path`` (a file no other group uses). A collective that waits
    longer than ``timeout_s`` raises instead of hanging."""
    store = dist.FileStore(store_path, tp)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=tp,
        timeout=datetime.timedelta(seconds=timeout_s))


def tp_group(tp: int) -> Optional[dist.ProcessGroup]:
    """The process group a ``tp``-way executor gathers over: the default
    group, which must hold exactly ``tp`` ranks. ``tp = 1`` outside a
    process group gives None (no collective at all); inside a one-rank
    group it gives that group, and the step runs the tp path with one
    shard."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if not (dist.is_available() and dist.is_initialized()):
        if tp == 1:
            return None
        raise RuntimeError(
            f"tp={tp} needs a process group of {tp} ranks: start the ranks "
            "with repro_torch.parallel.launch.spawn (or join them with "
            "init_tp)")
    world = dist.get_world_size()
    if world != tp:
        raise ValueError(f"tp={tp} but the process group has {world} ranks")
    return dist.group.WORLD


def rank_of(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def size_of(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_cat(x: torch.Tensor, group: dist.ProcessGroup,
                   dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order. For the
    attention heads each head was computed whole on one rank, so this is a
    copy, never a reduction: the result is the same bits at any tp."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
