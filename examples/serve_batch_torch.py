"""Serve a small model with batched requests through the port's engine.

  python examples/serve_batch_torch.py                # on the card
  python examples/serve_batch_torch.py --device cpu   # plain PyTorch

The counterpart of examples/serve_batch.py through ``repro_torch`` alone:
qwen2-0.5b's smoke config with weights drawn from seed 0, ten requests
through the dense engine built in the reference's keyword form
(``Engine(cfg, model, n_slots=4, max_seq=96)``), whose attention runs on
the hand-written ``flash_attention`` / ``flash_decode`` kernels on the
card. The smoke config computes in f32 here: its head dim of 16 runs on
``flash_attention``'s f32 kernel (the bf16 tensor-core kernel takes 32 to
128). ``main`` returns the finished requests and the engine.
"""
import argparse
import os
import sys
import time

if __name__ == "__main__":      # run as a file: find the package
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.engine import Engine, Request, resolve_device  # noqa


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32)
    model = transformer.init_model(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    eng = Engine(cfg, model, n_slots=4, max_seq=96, device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        eng.submit(Request(seq_id=i,
                           prompt=rng.integers(0, cfg.vocab, 6).astype(
                               np.int32),
                           max_new=args.max_new))
    done = eng.run(max_steps=2000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.tokens_out) for r in done)
    occ = float(np.mean(eng.stats["batch_occupancy"]))
    print(f"{len(done)} requests → {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, {device})")
    print(f"decode steps: {eng.stats['decode_steps']}  "
          f"mean batch occupancy: {occ:.2f}")
    for r in done[:3]:
        print(f"  seq {r.seq_id}: {r.tokens_out}")
    return done, eng


if __name__ == "__main__":
    main()
