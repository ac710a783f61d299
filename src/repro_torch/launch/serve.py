"""Serving driver: the chunked paged engine on random weights.

Usage (from the repository root; the script puts ``src`` on ``sys.path``)::

  python -m repro_torch.launch.serve --arch qwen2-0.5b --full --requests 8 \\
      --slots 8 --max-seq 2048 --token-budget 256 --prompt-len 512 \\
      --max-new 64                                   # on the card
  python -m repro_torch.launch.serve --device cpu --requests 4 --slots 2 \\
      --max-seq 32 --max-new 3 --page-tokens 8 --token-budget 6

``--full`` serves the published configuration (qwen2-0.5b at its full
width); without it the reduced smoke configuration. Weights are random,
drawn from a ``torch.Generator`` seeded with 0 (bf16 compute). The run prints the
same ``[serve:chunked]`` lines as the reference driver. ``--device``
defaults to ``cuda`` and the run fails without a card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

if __package__ in (None, ""):          # run as a file: find the package
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serve.cache import CacheConfig
from repro_torch.serve.engine import Engine, EngineConfig, Request, \
    resolve_device


def build_engine(args) -> Engine:
    """The engine the arguments describe, warmed up (see :func:`warm_up`)."""
    device = resolve_device(args.device)
    get = configs.get_config if args.full else configs.get_smoke_config
    cfg = get(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    model = transformer.init_model(cfg, gen, device)
    econf = EngineConfig(
        n_slots=args.slots, max_seq=args.max_seq, chunked=True,
        token_budget=args.token_budget, overlap=not args.no_overlap,
        trace=args.trace is not None,
        cache=CacheConfig(page_tokens=args.page_tokens, n_pages=args.pages))
    warm_up(cfg, model, econf, device)
    return Engine(cfg, model, config=econf, device=device)


def warm_up(cfg, model, config: EngineConfig, device) -> None:
    """Build the kernels and serve one short request on a throwaway engine
    with a small pool, so that a timed run that follows excludes the nvcc
    build and first-call costs (cuBLAS set-up, allocator growth)."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    eng = Engine(cfg, model, device=device, config=dataclasses.replace(
        config, cache=dataclasses.replace(config.cache, n_pages=64)))
    n = min(300, config.max_seq // 2)
    eng.submit(Request(seq_id=0, max_new=4,
                       prompt=np.arange(n, dtype=np.int32) % cfg.vocab))
    eng.run(max_steps=10000)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _print_profile(prof, wall: float, top: int) -> None:
    """Device time by kernel over the traced run, and the device's busy
    share of the run's wall time (kernels only; the profiler's own cost
    lengthens the wall time)."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"[serve:profile] device busy {busy_us / 1e3:.1f} ms of "
          f"{wall * 1e3:.1f} ms wall ({100 * busy_us / 1e3 / (wall * 1e3):.1f}"
          "%, profiled run)")
    for dev_us, count, key in rows[:top]:
        print(f"[serve:profile] {100 * dev_us / busy_us:5.1f}% "
              f"{dev_us / 1e3:9.2f} ms {count:6d}x  {key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--full", action="store_true",
                    help="the published configuration, not the smoke one")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--prompt-len-max", type=int, default=None,
                    help="draw each prompt length uniformly from "
                         "[prompt-len, prompt-len-max] (default: fixed)")
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--pages", type=int, default=None,
                    help="physical page-pool size (default: slots × max-seq)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="tokens per engine iteration (decode first, prompt "
                         "chunks fill the remainder)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="the synchronous step loop (streams are identical)")
    ap.add_argument("--metrics-log", type=int, default=0, metavar="N",
                    help="print a [metrics] JSON line every N iterations")
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="export a Chrome trace-event JSON timeline")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="on the card: trace the run with torch.profiler and "
                         "print the N kernels with the most device time")
    args = ap.parse_args(argv)

    # f32 products in full f32 on the card (no TF32), as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng = build_engine(args)
    cfg = eng.cfg
    rng = np.random.default_rng(0)
    lens = rng.integers(args.prompt_len,
                        (args.prompt_len_max or args.prompt_len) + 1,
                        args.requests)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]
    if args.profile and eng.device.type != "cuda":
        raise ValueError("--profile traces the card; it needs --device cuda")
    prof = _profiler() if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof:
        for i, p in enumerate(prompts):
            eng.submit(Request(seq_id=i, max_new=args.max_new, prompt=p))
        done, it = [], 0
        while not eng.idle and it < 100000:
            done.extend(eng.step())
            it += 1
            if args.metrics_log > 0 and it % args.metrics_log == 0:
                print(f"[metrics] {json.dumps(eng.metrics_snapshot())}",
                      flush=True)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    total_new = sum(len(r.tokens_out) for r in done)
    s = eng.stats_summary()
    a = eng.pool.alloc
    print(f"[serve:chunked] {len(done)} requests, {total_new} tokens in "
          f"{wall:.2f}s ({total_new / wall:.1f} tok/s), decode steps "
          f"{s['decode_steps']}, mean batch occupancy "
          f"{s['mean_occupancy']:.2f}")
    print(f"[serve:chunked] pool {a.n_pages} pages × {a.page_tokens} tok "
          f"({eng.pool.footprint_bytes()} B), free {a.free_pages}, "
          f"admission refusals {s['admission_refusals']}")
    print(f"[serve:chunked] token budget {s['token_budget']} "
          f"(max iter {s['max_iter_tokens']}), prefill chunks "
          f"{s['prefill_chunks']} ({s['prefill_chunk_tokens']} tok), "
          f"decode tokens {s['decode_tokens']}, ttft p50/p99 "
          f"{s['ttft_p50_s']:.3f}/{s['ttft_p99_s']:.3f} s")
    print(f"[serve:chunked] device {eng.device}"
          + (f" ({torch.cuda.get_device_name(eng.device)})"
             if eng.device.type == "cuda" else ""))
    if args.profile:
        _print_profile(prof, wall, args.profile)
    if args.trace is not None:
        path = eng.trace_export(args.trace)
        ts = eng.trace_summary()
        print(f"[serve:trace] -> {path}; stall% schedule/fetch/dma/"
              f"shadowed/other {ts['stall_pct_schedule']:.1f}/"
              f"{ts['stall_pct_fetch']:.1f}/{ts['stall_pct_dma']:.1f}/"
              f"{ts['stall_pct_shadowed']:.1f}/{ts['stall_pct_other']:.1f}")


if __name__ == "__main__":
    main()
