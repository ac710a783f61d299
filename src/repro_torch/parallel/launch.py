"""Start tensor-parallel ranks: one process a rank, joined in one group.

The port's tp is one process a rank (parallel/sharding.py). :func:`spawn`
starts ``tp`` processes with ``torch.multiprocessing`` (the ``spawn``
start method: nothing of the parent's state is forked), joins them to one
group through a ``FileStore`` in ``store_dir``, runs ``fn(rank, *args)``
on each and returns what each returned, in rank order. A rank that raises
fails the call with its traceback; ranks that do not finish within
``timeout_s`` are killed and the call raises, so a deadlocked collective
cannot hang the caller::

    from repro_torch.parallel import launch
    out = launch.spawn(fn, 2, (job,), store_dir=tmp, backend="gloo")

``launch/serve.py``'s ``--tp`` runs its ranks through it: NCCL with one
card a rank, or gloo on the CPU. Gloo also takes CUDA tensors (it stages
them through the host), so two gloo ranks can share one card.
"""
from __future__ import annotations

import gc
import os
import pickle
import time
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.parallel import sharding


def _rank_main(rank: int, payload: str, tp: int, store_dir: str,
               backend: str, timeout_s: float) -> None:
    with open(payload, "rb") as f:
        fn, args = pickle.load(f)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * tp)))
    sharding.init_tp(rank, tp, os.path.join(store_dir, "store"), backend,
                     timeout_s)
    try:
        out = fn(rank, *args)
        path = os.path.join(store_dir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        # an engine's reference cycles hold the group: free them, so the
        # group's threads stop here and not in the exit's static teardown
        # (where gloo's can abort the process)
        gc.collect()
        dist.destroy_process_group()
        gc.collect()


def spawn(fn: Callable, tp: int, args: Tuple = (), *, store_dir: str,
          backend: str, timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``tp`` new processes joined in one group
    (``backend``: ``"gloo"`` or ``"nccl"``); returns each rank's result.
    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    ``store_dir`` must be a directory no other group uses. ``fn`` and
    ``args`` reach the ranks through a file there: through the start
    pipe, arguments past its buffer would hold the parent until each new
    process had imported what they name, so the ranks would start one
    after another."""
    os.makedirs(store_dir, exist_ok=True)
    payload = os.path.join(store_dir, "payload.pkl")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.start_processes(
        _rank_main, args=(payload, tp, store_dir, backend, timeout_s),
        nprocs=tp, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"tp={tp} ranks did not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    out = []
    for r in range(tp):
        with open(os.path.join(store_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
