"""End-to-end driver on the port: train a ~100M-parameter LM for a few
hundred steps on the synthetic structured stream, with checkpointing and
fault tolerance.

  python examples/train_lm_torch.py --steps 300                # on the card
  python examples/train_lm_torch.py --device cpu --smoke --steps 3

The counterpart of examples/train_lm.py through ``repro_torch`` alone: the
same qwen2-family config scaled to ~100M parameters (d 640, 10 layers,
vocab 32k), trained by ``repro_torch.launch.train.train`` (the driver's
entry point: deterministic data, AdamW, async checkpoints, rollback on a
failed step). The config reaches it as overrides of every field of a
registered arch's, so no arch is registered on the fly. ``--smoke``
shrinks the config for a quick run. Expect the loss to drop from ~10.4
toward ~2-4 (the stream is 70% periodic n-grams). ``main`` returns the
losses.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

if __name__ == "__main__":      # run as a file: find the package
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))

from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


def config_100m():
    return transformer.ModelConfig(
        name="demo-100m", family="dense",
        d_model=640, n_heads=10, n_kv=2, d_ff=2560, vocab=32000,
        groups=((("gqa:mlp",), 10),),
        tie_embeddings=True, rope_theta=10000.0, remat="none",
        q_chunk=256, kv_chunk=256,
    )


def config_smoke():
    return dataclasses.replace(config_100m(), name="demo-smoke", d_model=64,
                               n_heads=4, d_ff=128, vocab=512,
                               groups=((("gqa:mlp",), 2),), q_chunk=64,
                               kv_chunk=64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer, 64-wide config of the same family")
    args = ap.parse_args(argv)

    cfg = config_smoke() if args.smoke else config_100m()
    # every field of the demo config, over qwen2-0.5b's (the driver builds
    # a registered arch's config, then replaces its fields)
    overrides = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
    losses = train("qwen2-0.5b", smoke=False, steps_total=args.steps,
                   ckpt_dir=args.ckpt_dir, batch=args.batch, seq=args.seq,
                   lr=1e-3, ckpt_every=50, device=args.device,
                   overrides=overrides)
    print(f"final loss {losses[-1]:.3f} (start {losses[0]:.3f})")
    return losses


if __name__ == "__main__":
    main()
