"""The fault-tolerant training driver.

Counterpart of ``repro/launch/train.py`` on one device (the reference
builds a data mesh over every device it sees; the port has one card):
deterministic data (data/pipeline.py, skip-ahead on restart) → the train
step (train/step.py) wrapped as an offload ``TargetRegion`` → async
checkpoints (checkpoint/manager.py) → the watchdog:

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
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Optional

import torch

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
          on_step: Optional[Callable] = None):
    """Train ``arch`` (its smoke config with ``smoke``) for
    ``steps_total`` steps on ``device`` → the loss of every step taken, in
    order, a rolled-back step's too, as the reference keeps it.
    ``on_step(step, loss, seconds, state)`` is called after each completed
    step (``step`` counts it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train: no CUDA device; pass "
                           "--device cpu to train on the CPU")
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    mgr = CheckpointManager(ckpt_dir)
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                         seed=seed, mtp=cfg.mtp)

    state = build_state(cfg, seed, device)
    start_step = 0
    if mgr.latest_step() is not None:
        restored, extra = mgr.restore(steps.state_tree(state))
        steps.load_state(state, restored)
        start_step = int(extra.get("data_step", mgr.latest_step()))
        print(f"[train] restored step {start_step} from {ckpt_dir}")

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
            state, metrics = region(state, dp.to_device(b, device))
            if inject_failure is not None and step == inject_failure:
                inject_failure = None  # fire once
                raise SimulatedFailure(f"injected at step {step}")
            loss = float(metrics["loss"])  # waits for the step
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.time() - t0
            if dt > step_timeout:
                raise TimeoutError(f"straggler: step took {dt:.1f}s")
            losses.append(loss)
            step += 1
            if on_step is not None:
                on_step(step, loss, dt, state)
            if step % log_every == 0:
                tok_s = b["tokens"].size / dt
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt:.2f}s, {tok_s:,.0f} tok/s)", flush=True)
            if step % ckpt_every == 0:
                mgr.save(step, steps.state_tree(state),
                         extra={"data_step": step}, blocking=False)
        except (SimulatedFailure, TimeoutError) as e:
            print(f"[train] FAILURE at step {step}: {e} — rolling back")
            mgr.wait()
            if mgr.latest_step() is not None:
                restored, extra = mgr.restore(steps.state_tree(state))
                steps.load_state(state, restored)
                step = int(extra.get("data_step", mgr.latest_step()))
            else:
                state = build_state(cfg, seed, device)
                step = 0
            print(f"[train] resumed at step {step}")
    mgr.wait()
    mgr.save(step, steps.state_tree(state), extra={"data_step": step})
    wall = time.time() - t_start
    print(f"[train] done: {step} steps in {wall:.1f}s; "
          f"loss {losses[0]:.3f} → {losses[-1]:.3f}" if losses else
          f"[train] done: {step} steps in {wall:.1f}s; no step taken")
    return losses


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
    args = ap.parse_args(argv)
    train(args.arch, args.smoke, args.steps, args.ckpt_dir, args.batch,
          args.seq, args.lr, ckpt_every=args.ckpt_every,
          step_timeout=args.step_timeout,
          inject_failure=args.inject_failure, grad_accum=args.grad_accum,
          compress=args.compress, device=args.device)


if __name__ == "__main__":
    main()
