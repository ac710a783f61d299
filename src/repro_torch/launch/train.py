"""The fault-tolerant training driver.

Counterpart of ``repro/launch/train.py``: deterministic data
(data/pipeline.py, skip-ahead on restart) → the train step (train/step.py)
wrapped as an offload ``TargetRegion`` → async checkpoints
(checkpoint/manager.py) → the watchdog:

  * at start the newest valid checkpoint is restored and the loop resumes
    at its ``data_step``;
  * a checkpoint every ``--ckpt-every`` steps, and one at the end;
  * a step that takes longer than ``--step-timeout`` seconds, or the
    failure ``--inject-failure N`` simulates once at step N, rolls the
    state back to the newest checkpoint (a fresh one without any) and
    resumes at its data step.

Each step ends in a read of its loss (``float``), which waits for the
device, and on the card in ``torch.cuda.synchronize()``. Usage::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 6 --ckpt-dir "$TMPDIR/ckpt_torch"

Without ``--device cpu`` it runs on the card, and raises where there is
none. ``--ckpt-dir`` has no default: the run resumes from whatever
checkpoint that directory holds, so each run names its own.

``--ranks N`` trains data-parallel in the FSDP layout, as the reference's
driver does over the (devices, 1) mesh it builds: N ranks
(parallel/launch.py ``spawn``, gloo; on the card every rank on cuda:0)
over launch/mesh.py ``make_dev_mesh``, each holding its shards of the
state and its rows of each batch (train/step.py). Checkpoints hold whole
leaves (rank 0 writes them), and a restore hands each rank its slice, so
a run may resume at another rank count (the reference's elastic
restart). Every rank takes the same control flow: the injected failure
fires at the same step on all, a step's time is the slowest rank's, and
a rollback waits for rank 0's save in flight before any rank reads.
Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

if __package__ in (None, ""):   # run as a file: put src/ on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from repro_torch import configs                       # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core.offload import TargetRegion      # noqa: E402
from repro_torch.data import pipeline as dp            # noqa: E402
from repro_torch.models import transformer             # noqa: E402
from repro_torch.optim import adamw                    # noqa: E402
from repro_torch.parallel import compression           # noqa: E402
from repro_torch.parallel import launch as ranks_lib    # noqa: E402
from repro_torch.train import step as steps            # noqa: E402


class SimulatedFailure(RuntimeError):
    pass


def build_state(cfg, seed: int, device) -> steps.TrainState:
    """Weights drawn from ``seed`` on ``device`` (the reference's
    distributions, models/transformer.py ``init_model``), a fresh state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return steps.init_state(transformer.init_model(cfg, gen, device))


def train(arch: str, smoke: bool, steps_total: int, ckpt_dir: str,
          batch: int, seq: int, lr: float, ckpt_every: int = 25,
          step_timeout: float = 600.0, inject_failure: Optional[int] = None,
          grad_accum: int = 1, compress: str = "none", seed: int = 0,
          log_every: int = 10, device="cuda",
          on_step: Optional[Callable] = None, mesh=None,
          overrides: Optional[Dict[str, Any]] = None):
    """Train ``arch`` (its smoke config with ``smoke``; ``overrides``: its
    fields replaced, as ``configs.get_config`` takes them) for
    ``steps_total`` steps on ``device`` → the loss of every step taken, in
    order, a rolled-back step's too, as the reference keeps it.
    ``on_step(step, loss, seconds, state, metrics)`` is called after each
    completed step (``step`` counts it; ``metrics`` the step's).
    ``mesh``: this rank's data mesh (launch/mesh.py ``make_dev_mesh``) to
    train in the FSDP layout; every rank of it calls ``train`` alike."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train: no CUDA device; pass "
                           "--device cpu to train on the CPU")
    cfg = (configs.get_smoke_config if smoke
           else configs.get_config)(arch, **(overrides or {}))
    mgr = CheckpointManager(ckpt_dir)
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                         seed=seed, mtp=cfg.mtp)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    def fresh():
        state = build_state(cfg, seed, device)
        return state if mesh is None else steps.shard_state(state, mesh)

    def save(step, blocking):
        tree = (steps.state_tree(state) if mesh is None
                else steps.whole_state(state, keep=lead))
        if lead:
            mgr.save(step, tree, extra={"data_step": step},
                     blocking=blocking)

    def restore():
        """Rank 0's save in flight lands first; → the restored data step."""
        mgr.wait()
        if mesh is not None:
            dist.barrier()
        restored, extra = mgr.restore(
            steps.state_tree(state), shardings=None if mesh is None
            else steps.state_shardings(state))
        steps.load_state(state, restored)
        return int(extra.get("data_step", mgr.latest_step()))

    state = fresh()
    start_step = 0
    if mgr.latest_step() is not None:
        start_step = restore()
        say(f"[train] restored step {start_step} from {ckpt_dir}")

    comp = (compression.Compressor(mode=compress) if compress != "none"
            else None)
    ts_fn = steps.make_train_step(
        cfg, adamw.Config(lr=lr, total_steps=max(steps_total, 1)),
        grad_accum=grad_accum, compressor=comp)
    region = TargetRegion(ts_fn, name=f"train_{cfg.name}")

    step = start_step
    t_start = time.time()
    losses = []
    while step < steps_total:
        try:
            t0 = time.time()
            b = dp.make_batch(dcfg, step)
            rows = b if mesh is None else steps.rank_rows(b, grad_accum,
                                                          mesh)
            state, metrics = region(state, dp.to_device(rows, device))
            if inject_failure is not None and step == inject_failure:
                inject_failure = None  # fire once
                raise SimulatedFailure(f"injected at step {step}")
            loss = float(metrics["loss"])  # waits for the step
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.time() - t0
            if mesh is not None:          # every rank judges the same time
                slowest = torch.tensor([dt], dtype=torch.float64)
                dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
                dt = float(slowest)
            if dt > step_timeout:
                raise TimeoutError(f"straggler: step took {dt:.1f}s")
            losses.append(loss)
            step += 1
            if on_step is not None:
                on_step(step, loss, dt, state, metrics)
            if step % log_every == 0:
                tok_s = b["tokens"].size / dt
                say(f"[train] step {step} loss {loss:.4f} "
                    f"({dt:.2f}s, {tok_s:,.0f} tok/s)", flush=True)
            if step % ckpt_every == 0:
                save(step, blocking=False)
        except (SimulatedFailure, TimeoutError) as e:
            say(f"[train] FAILURE at step {step}: {e} — rolling back")
            mgr.wait()
            if mesh is not None:
                dist.barrier()
            if mgr.latest_step() is not None:
                step = restore()
            else:
                state = fresh()
                step = 0
            say(f"[train] resumed at step {step}")
    mgr.wait()
    save(step, blocking=True)
    wall = time.time() - t_start
    say(f"[train] done: {step} steps in {wall:.1f}s; "
        f"loss {losses[0]:.3f} → {losses[-1]:.3f}" if losses else
        f"[train] done: {step} steps in {wall:.1f}s; no step taken")
    return losses


def _rank_train(rank: int, kwargs) -> list:
    """One rank of ``--ranks N``: the data mesh over the spawned group,
    then :func:`train` (only rank 0 prints)."""
    from repro_torch.launch.mesh import make_dev_mesh
    return train(**kwargs, mesh=make_dev_mesh())


def train_ranks(n: int, timeout_s: float = 3600.0, **kwargs) -> list:
    """:func:`train` on ``n`` spawned gloo ranks (``kwargs`` as
    :func:`train`'s, ``device`` shared by every rank) → rank 0's losses.
    A rank that raises fails the call; the ranks must finish within
    ``timeout_s`` (a collective waits as long)."""
    with tempfile.TemporaryDirectory() as store:
        out = ranks_lib.spawn(_rank_train, n, (kwargs,), store_dir=store,
                              backend="gloo", timeout_s=timeout_s)
    return out[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoints go here; a run restores the newest")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--step-timeout", type=float, default=600.0)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--ranks", type=int, default=1,
                    help="data-parallel ranks in the FSDP layout (gloo; "
                         "on the card all on cuda:0)")
    args = ap.parse_args(argv)
    kw = dict(arch=args.arch, smoke=args.smoke, steps_total=args.steps,
              ckpt_dir=args.ckpt_dir, batch=args.batch, seq=args.seq,
              lr=args.lr, ckpt_every=args.ckpt_every,
              step_timeout=args.step_timeout,
              inject_failure=args.inject_failure, grad_accum=args.grad_accum,
              compress=args.compress, device=args.device)
    if args.ranks > 1:
        train_ranks(args.ranks, **kw)
    else:
        train(**kw)


if __name__ == "__main__":
    main()
