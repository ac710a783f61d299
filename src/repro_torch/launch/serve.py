"""Serving driver: the dense, monolithic paged or chunked engine, or a fleet.

Usage (from the repository root; the script puts ``src`` on ``sys.path``)::

  python -m repro_torch.launch.serve --arch qwen2-0.5b --full --requests 8 \\
      --slots 8 --max-seq 2048 --chunked-prefill --token-budget 256 \\
      --prompt-len 512 --max-new 64                  # on the card
  python -m repro_torch.launch.serve --device cpu --requests 4 --slots 2 \\
      --max-seq 32 --max-new 3                       # dense
  python -m repro_torch.launch.serve --device cpu --requests 4 --slots 2 \\
      --max-seq 32 --max-new 3 --paged --page-tokens 8   # monolithic paged
  python -m repro_torch.launch.serve --device cpu --requests 4 --slots 2 \\
      --max-seq 32 --max-new 3 --chunked-prefill --page-tokens 8 \\
      --token-budget 6                               # chunked
  python -m repro_torch.launch.serve --device cpu --kv-dtype int8 \\
      --prefix-cache --shared-prefix-len 8 --prompt-len 2 --requests 6 \\
      --slots 2 --max-seq 32 --max-new 3 --page-tokens 8 --token-budget 8

As in the reference driver, the engine is the **dense** one unless a flag
asks for pages: ``--paged`` (or ``--tiered``, or ``--kv-dtype int8``) serves
the monolithic paged engine (whole prompts prefilled, then scattered into
pages), ``--chunked-prefill`` (implied by ``--prefix-cache``) the chunked
one (token-budgeted prompt chunks and decode in one loop). ``--full``
serves the published configuration (the arch at its full width);
without it the reduced smoke configuration. Weights are random, drawn from
a ``torch.Generator`` seeded with 0 (bf16 compute). The run prints the
same ``[serve:<mode>]`` lines as the reference driver. ``--device``
defaults to ``cuda`` and the run fails without a card unless ``--device
cpu`` is given.

``--replicas N`` routes the requests through a fleet of N engines
(serve/router.py) sharing the weights: placement by the longest prefix
fingerprint match, then the least loaded (``--router round_robin``: in
turn). The run prints the reference's ``[serve:fleet]`` lines::

  python -m repro_torch.launch.serve --device cpu --prefix-cache \\
      --shared-prefix-len 8 --prompt-len 2 --requests 6 --slots 2 \\
      --max-seq 32 --max-new 3 --page-tokens 8 --token-budget 8 \\
      --replicas 2 --router prefix

``--arch`` picks yi-34b, minitron-4b or gemma3-27b as well as
qwen2-0.5b; with ``--full`` the weights are drawn at bf16 (yi-34b's 68.8
GB fit one 80 GB card beside a 4 GB pool; gemma3-27b's 54.0 GB beside 8 ×
2048-token slots, 4.8 GB with its sliding-window rings). gemma3-27b serves
through the dense engine only, as in the reference: its local layers are
not pageable, so ``--paged``, ``--chunked-prefill``, int8 pages and
``--tp`` refuse it::

  python -m repro_torch.launch.serve --arch gemma3-27b --full --requests 8 \\
      --slots 8 --max-seq 2048 --prompt-len 128 --prompt-len-max 1536 \\
      --max-new 64                                   # one card

xlstm-1.3b and zamba2-1.2b (recurrent layers, models/ssm.py; zamba2's
weight-shared attention block) serve through the dense engine only, as in
the reference: their recurrent layers are not pageable, so ``--paged``,
``--chunked-prefill``, int8 pages and ``--tp`` refuse them with the page
pool's message::

  python -m repro_torch.launch.serve --arch xlstm-1.3b --full --requests 8 \\
      --slots 8 --max-seq 2048 --prompt-len 128 --prompt-len-max 1536 \\
      --max-new 64                                   # one card

deepseek-v3-671b (MLA over a latent cache, 256 experts top-8 with a
shared one) serves through the dense engine only, as in the reference:
its MLA layers are not pageable, so ``--paged``, ``--chunked-prefill``,
int8 pages and ``--tp`` refuse it with the page pool's message before
any weight is drawn. Its published config (61 layers, 1.37 TB at bf16)
fits no card (``--full`` runs out of device memory while drawing it);
``chip_smoke.py`` phase 7o serves it at full width cut in depth to 3
dense + 2 MoE layers::

  python -m repro_torch.launch.serve --device cpu --arch deepseek-v3-671b \
      --requests 3 --slots 2 --max-seq 48 --max-new 3   # the smoke config

llama-3.2-vision-11b and whisper-medium are registered, but no engine
serves them (the reference's neither: they need encoder input at
prefill), so ``--arch`` with either raises a ValueError that names the
prefill / decode steps of ``train/step.py``, their entry point.

``--tp N`` serves with tensor parallelism (it implies the paged engine,
as the reference's flag does): N ranks start with
``torch.multiprocessing``, each holding ``n_kv / N`` kv heads of
every KV page and the whole weights; on the card rank r takes ``cuda:r``
over NCCL (the run needs N cards), on the CPU the ranks talk gloo. Every
rank's scheduler reads rank 0's clock (broadcast over gloo), so the SLO
flags, ``--itl-target-ms`` included, work under tp, and a ``clock:`` line
gives the broadcasts an iteration. The kernels are built before the ranks
start, and only rank 0 prints::

  python -m repro_torch.launch.serve --device cpu --tp 2 --chunked-prefill \
      --requests 4 --slots 2 --max-seq 32 --max-new 3 --page-tokens 8 \
      --token-budget 6
  python -m repro_torch.launch.serve --arch yi-34b --full --chunked-prefill \
      --requests 8 --slots 8 --max-seq 2048 --token-budget 256 \
      --prompt-len 128 --prompt-len-max 1536 --max-new 64   # one card

``--kv-dtype int8`` stores the KV pages in int8 with per-(page, kv head)
scales; ``--prefix-cache`` adds the shared-prefix layer (``--prefix-cache-
pages`` caps the pages its cache may pin), and ``--shared-prefix-len N``
puts the same N-token system prompt in front of every request, so later
arrivals reuse its pages. A prefix run prints a ``prefix hits H (F full),
shared tokens S ...`` line; prefill chunk tokens then equal the prompts'
total less S.

``--tiered`` puts a host-DRAM swap tier under the page pool: when the hot
tier (``--pages``) is full, the least recently decoded resident swaps out
and resumes later at its chunk offset; ``--host-budget-mb`` bounds the
cold tier and ``--preempt-quantum`` sets how many decode steps a resident
is exempt. The run prints a ``[serve:tiered] preemptions ...`` line.
``--trace PATH`` exports the execution trace (``--trace-buffer N`` bounds
its event ring; the ``[serve:trace]`` line counts the events kept and
dropped). ``--max-in-system`` / ``--max-queue`` attach the SLO policy's
admission gate and load shedding, ``--itl-target-ms`` its decode-latency
budget shaping, and ``--priorities N`` cycles the requests through N
priority classes; a policy run prints ``[serve:slo] shed N (code: n, ...)``::

  python -m repro_torch.launch.serve --device cpu --tiered --pages 6 \\
      --page-tokens 8 --requests 6 --slots 2 --max-seq 32 --max-new 3 \\
      --token-budget 6 --priorities 2 --max-in-system 2 --max-queue 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time

if __package__ in (None, ""):          # run as a file: find the package
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serve.cache import CacheConfig
from repro_torch.serve.engine import Engine, EngineConfig, Request, \
    check_servable, resolve_device
from repro_torch.serve.kvcache import check_pageable
from repro_torch.serve.policy import PolicyConfig


def build_engine(args) -> Engine:
    """The engine the arguments describe, warmed up (see :func:`warm_up`)."""
    cfg, model, econf, device = build_config(args)
    return Engine(cfg, model, config=econf, device=device)


def build_config(args):
    """(model config, model, engine config, device) for the arguments, the
    model warmed up on a throwaway engine (see :func:`warm_up`)."""
    device = resolve_device(args.device)
    if args.full:       # bf16 leaves: the executor's cast copies nothing
        cfg = configs.get_config(args.arch, param_dtype=torch.bfloat16)
    else:
        cfg = configs.get_smoke_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    model = transformer.init_model(cfg, gen, device)
    econf = engine_config(args)
    warm_up(cfg, model, econf, device)
    return cfg, model, econf, device


def engine_config(args) -> EngineConfig:
    """The engine configuration the arguments describe."""
    policy = None
    if (args.max_in_system is not None or args.max_queue is not None
            or args.itl_target_ms is not None):
        policy = PolicyConfig(
            max_in_system=args.max_in_system, max_queue=args.max_queue,
            itl_target_s=(args.itl_target_ms / 1000.0
                          if args.itl_target_ms is not None else None))
    trace_kw = {}
    if args.trace_buffer is not None:
        trace_kw["trace_buffer"] = args.trace_buffer
    return EngineConfig(
        n_slots=args.slots, max_seq=args.max_seq,
        chunked=args.chunked_prefill, token_budget=args.token_budget,
        preempt_quantum=args.preempt_quantum,
        overlap=not args.no_overlap, policy=policy, tp=args.tp,
        trace=args.trace is not None, **trace_kw,
        cache=CacheConfig(paged=args.paged, page_tokens=args.page_tokens,
                          n_pages=args.pages,
                          tiered=args.tiered,
                          host_budget_bytes=(args.host_budget_mb * 2**20
                                             if args.host_budget_mb
                                             else None),
                          prefix=args.prefix_cache,
                          prefix_pages=args.prefix_cache_pages,
                          kv_dtype=args.kv_dtype))


def warm_up(cfg, model, config: EngineConfig, device) -> None:
    """Build the kernels and serve one short request on a throwaway engine
    with a small pool, so that a timed run that follows excludes the nvcc
    build and first-call costs (cuBLAS set-up, allocator growth). The
    throwaway engine (a dense one holds its whole slot pool: 4.8 GB for
    gemma3-27b) is let go before this returns, so the timed engine's pool
    is the only one resident."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    eng = Engine(cfg, model, device=device, config=dataclasses.replace(
        config, cache=dataclasses.replace(config.cache, n_pages=64)))
    n = min(300, config.max_seq // 2)
    eng.submit(Request(seq_id=0, max_new=4,
                       prompt=np.arange(n, dtype=np.int32) % cfg.vocab))
    eng.run(max_steps=10000)
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(eng.device)
    del eng
    gc.collect()              # the engine's scheduler callbacks form cycles
    if cuda:
        torch.cuda.empty_cache()


def _serve_fleet(args) -> None:
    """``--replicas N``: the requests through a fleet of N engines sharing
    the weights (serve/router.py), then the reference's fleet lines."""
    from repro_torch.serve.router import Fleet
    cfg, model, econf, device = build_config(args)
    prompts = _prompts(args, cfg)
    fleet = Fleet(cfg, model, econf, replicas=args.replicas,
                  router=args.router, device=device)
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        fleet.submit(Request(
            seq_id=i, max_new=args.max_new, prompt=p,
            priority=i % args.priorities if args.priorities else 0))
    done, it = [], 0
    while not fleet.idle and it < 100000:
        done.extend(fleet.step())
        it += 1
        if args.metrics_log > 0 and it % args.metrics_log == 0:
            print(f"[metrics] {json.dumps(fleet.metrics_snapshot())}",
                  flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    total_new = sum(len(r.tokens_out) for r in done)
    ss = fleet.stats_summary()
    fs = ss["fleet"]
    print(f"[serve:fleet] {args.replicas} replicas ({args.router} router): "
          f"{len(done)} requests, {total_new} tokens in {wall:.2f}s "
          f"({total_new / wall:.1f} tok/s); routed {fs['routed']} "
          f"({fs['routed_prefix']} prefix-affine, "
          f"{fs['routed_prefix_tokens']} matched tok), backpressure waits "
          f"{fs['backpressure_waits']}, shed {fs['shed']}")
    for name, s in sorted(ss["per_replica"].items()):
        rinfo = fs["replicas"][name]
        print(f"[serve:fleet]   {name} ({rinfo['state']}, gen "
              f"{rinfo['generation']}): finished {rinfo['finished']}, "
              f"decode steps {s['decode_steps']}, prefill chunk tokens "
              f"{s.get('prefill_chunk_tokens', 0)}, prefix shared tokens "
              f"{s.get('prefix_shared_tokens', 0)}")


def profiler():
    """A torch.profiler that traces the card's kernels (used as a context
    manager, or started and stopped around a window of iterations)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA], acc_events=True)


def profile_rows(prof):
    """``(busy_us, rows)`` of a finished :func:`profiler`: the device's
    kernel time summed (its busy time), and ``(device µs, count, name)``
    a kernel name, most device time first."""
    from torch.autograd import DeviceType
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total), reverse=True)
    return sum(r[0] for r in rows), rows


def _print_profile(prof, wall: float, top: int) -> None:
    """Device time by kernel over the traced run, and the device's busy
    share of the run's wall time (kernels only; the profiler's own cost
    lengthens the wall time)."""
    busy_us, rows = profile_rows(prof)
    print(f"[serve:profile] device busy {busy_us / 1e3:.1f} ms of "
          f"{wall * 1e3:.1f} ms wall ({100 * busy_us / 1e3 / (wall * 1e3):.1f}"
          "%, profiled run)")
    for dev_us, count, key in rows[:top]:
        print(f"[serve:profile] {100 * dev_us / busy_us:5.1f}% "
              f"{dev_us / 1e3:9.2f} ms {count:6d}x  {key[:90]}")


def _tp_rank(rank: int, args) -> None:
    """One rank of ``--tp N``: this rank's device, then the same run as one
    process; ranks other than 0 print nothing."""
    if args.device.startswith("cuda"):
        args.device = f"cuda:{rank}"
        torch.cuda.set_device(args.device)
    with contextlib.ExitStack() as stack:
        if rank:
            devnull = stack.enter_context(open(os.devnull, "w"))
            stack.enter_context(contextlib.redirect_stdout(devnull))
        _serve(args)


def _spawn_tp(args) -> None:
    """``--tp N``: N ranks over gloo on the CPU or NCCL on N cards."""
    from repro_torch.parallel import launch
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        resolve_device(args.device)
        if torch.cuda.device_count() < args.tp:
            raise RuntimeError(
                f"--tp {args.tp} takes one card a rank; "
                f"{torch.cuda.device_count()} visible")
        from repro_torch.kernels import _build
        _build.build_all()      # before the ranks: none races on the build
    with tempfile.TemporaryDirectory() as store:
        launch.spawn(_tp_rank, args.tp, (args,), store_dir=store,
                     backend="nccl" if cuda else "gloo", timeout_s=3600.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=configs.ARCHS)
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
    ap.add_argument("--paged", action="store_true",
                    help="the monolithic paged engine (default: dense)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="the chunked engine: token-budgeted prompt chunks "
                         "and decode in one step loop (implies --paged)")
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--pages", type=int, default=None,
                    help="physical page-pool size (default: slots × max-seq)")
    ap.add_argument("--kv-dtype", choices=("compute", "int8"),
                    default="compute",
                    help="KV page storage: 'compute' keeps pages at the "
                         "compute dtype; 'int8' quantizes them with "
                         "per-(page, kv-head) f32 scales")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix KV reuse: radix prompt index + "
                         "ref-counted copy-on-write pages (implies "
                         "--chunked-prefill)")
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    help="most pages the prefix cache may pin "
                         "(default: half the pool)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="put the same system prompt of this many tokens in "
                         "front of every request")
    ap.add_argument("--tiered", action="store_true",
                    help="host-DRAM swap tier under the page pool "
                         "(preemptive scheduling)")
    ap.add_argument("--host-budget-mb", type=int, default=None,
                    help="cold-tier budget in MiB (HeroMemory L3; default: "
                         "eight hot pools)")
    ap.add_argument("--preempt-quantum", type=int, default=1,
                    help="decode steps a resident is exempt from eviction")
    ap.add_argument("--max-in-system", type=int, default=None,
                    help="SLO policy: cap concurrently resident requests "
                         "(admission gate)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="SLO policy: cap the waiting line; the lowest-"
                         "priority tail beyond it is shed with a typed "
                         "verdict")
    ap.add_argument("--itl-target-ms", type=float, default=None,
                    help="SLO policy: decode inter-token-latency p99 target; "
                         "prefill's budget share is squeezed while over it")
    ap.add_argument("--priorities", type=int, default=0,
                    help="cycle the requests through this many priority "
                         "classes (0: all in the default class)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="tokens per chunked iteration (decode first, "
                         "prompt chunks fill the remainder)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="the synchronous step loop (streams are identical)")
    ap.add_argument("--metrics-log", type=int, default=0, metavar="N",
                    help="print a [metrics] JSON line every N iterations")
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="export a Chrome trace-event JSON timeline")
    ap.add_argument("--trace-buffer", type=int, default=None, metavar="N",
                    help="tracer event-ring capacity (oldest events drop "
                         "first; default 65536)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a fleet of this many engines "
                         "(serve/router.py); 1: one engine")
    ap.add_argument("--router", choices=("prefix", "round_robin"),
                    default="prefix",
                    help="fleet placement: longest prefix-fingerprint match "
                         "(least-loaded tie-break) or round robin")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="on the card: trace the run with torch.profiler and "
                         "print the N kernels with the most device time")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (kv heads sharded over "
                         "them; implies --paged); one card a rank")
    args = ap.parse_args(argv)
    check_servable(configs.get_smoke_config(args.arch))   # before any weight
    if args.replicas > 1 and (args.profile or args.trace is not None):
        ap.error("--profile and --trace follow one engine; they do not "
                 "combine with --replicas > 1")
    if engine_config(args).normalized().cache.paged:    # before any weight
        check_pageable(configs.get_smoke_config(args.arch))
    if args.tp > 1:
        _spawn_tp(args)
    else:
        _serve(args)


def _serve(args) -> None:
    # f32 products in full f32 on the card (no TF32), as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.replicas > 1:
        _serve_fleet(args)
        return
    eng = build_engine(args)
    cfg = eng.cfg
    prompts = _prompts(args, cfg)
    if args.profile and eng.device.type != "cuda":
        raise ValueError("--profile traces the card; it needs --device cuda")
    prof = profiler() if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof:
        for i, p in enumerate(prompts):
            eng.submit(Request(
                seq_id=i, max_new=args.max_new, prompt=p,
                priority=i % args.priorities if args.priorities else 0))
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
    chunked, paged = eng.config.chunked, eng.config.cache.paged
    mode = "tiered" if args.tiered else ("paged" if paged else "dense")
    if chunked:
        mode = "chunked+tiered" if args.tiered else "chunked"
    if args.prefix_cache:
        mode = "prefix+" + mode
    if args.tp > 1:
        mode = f"tp{args.tp}+" + mode
    if args.kv_dtype != "compute":
        mode = f"{args.kv_dtype}+" + mode
    print(f"[serve:{mode}] {len(done)} requests, {total_new} tokens in "
          f"{wall:.2f}s ({total_new / wall:.1f} tok/s), decode steps "
          f"{s['decode_steps']}, mean batch occupancy "
          f"{s['mean_occupancy']:.2f}")
    if paged:
        a = eng.pool.alloc
        print(f"[serve:{mode}] pool {a.n_pages} pages × {a.page_tokens} tok "
              f"({eng.pool.footprint_bytes()} B), free {a.free_pages}, "
              f"admission refusals {s['admission_refusals']}")
    else:
        print(f"[serve:{mode}] pool {eng.pool.n_slots} slots × "
              f"{eng.pool.max_seq} tok ({eng.pool.footprint_bytes()} B "
              f"estimated, {eng.pool.leaf_nbytes()} B of leaves), "
              f"ttft p50/p99 {s['ttft_p50_s']:.3f}/{s['ttft_p99_s']:.3f} s")
    if args.prefix_cache:
        print(f"[serve:{mode}] prefix hits {s['prefix_hits']} "
              f"({s['prefix_full_hits']} full), shared tokens "
              f"{s['prefix_shared_tokens']}, cached pages "
              f"{s['prefix_held_pages']}, cow forks {s['cow_forks']}, "
              f"evicted pages {s['prefix_evicted_pages']}")
    if chunked:
        print(f"[serve:{mode}] token budget {s['token_budget']} "
              f"(max iter {s['max_iter_tokens']}), prefill chunks "
              f"{s['prefill_chunks']} ({s['prefill_chunk_tokens']} tok), "
              f"decode tokens {s['decode_tokens']}, ttft p50/p99 "
              f"{s['ttft_p50_s']:.3f}/{s['ttft_p99_s']:.3f} s")
    if eng.scheduler.policy is not None:
        by_code = {}
        for r in eng.shed:
            by_code[r.verdict.code] = by_code.get(r.verdict.code, 0) + 1
        codes = ", ".join(f"{c}: {n}" for c, n in sorted(by_code.items()))
        print(f"[serve:slo] shed {s['shed']} ({codes or 'none'}), "
              f"itl p50/p99 "
              f"{s['itl_p50_s'] * 1e3:.1f}/{s['itl_p99_s'] * 1e3:.1f} ms")
    if args.tiered:
        print(f"[serve:tiered] preemptions {s['preemptions']}, swap out "
              f"{s['swap_out_count']}×/{s['swap_out_bytes']} B, swap in "
              f"{s['swap_in_count']}×/{s['swap_in_bytes']} B, peak host "
              f"{s['peak_host_bytes']} B, peak in-system "
              f"{s['peak_in_system']} seqs, queue p50/p90/p99 "
              f"{s['queue_lat_p50_s']:.3f}/{s['queue_lat_p90_s']:.3f}/"
              f"{s['queue_lat_p99_s']:.3f} s")
    if args.tp > 1:
        reads = eng.executor.stats["clock_reads"]
        print(f"[serve:{mode}] clock: {reads} reads of rank 0's clock "
              f"broadcast over {it} iterations ({reads / max(it, 1):.2f} an "
              "iteration)")
    print(f"[serve:{mode}] device {eng.device}"
          + (f" ({torch.cuda.get_device_name(eng.device)}), peak memory "
             f"{torch.cuda.max_memory_allocated(eng.device) / 2**30:.2f} GiB"
             if eng.device.type == "cuda" else ""))
    if args.profile:
        _print_profile(prof, wall, args.profile)
    if args.trace is not None:
        path = eng.trace_export(args.trace)
        ts = eng.trace_summary()
        ev = eng.tracer.stats()
        print(f"[serve:trace] {ev['iterations']} iterations, "
              f"{ev['events']} events ({ev['dropped']} dropped) -> {path}; "
              f"stall% schedule/fetch/dma/"
              f"shadowed/other {ts['stall_pct_schedule']:.1f}/"
              f"{ts['stall_pct_fetch']:.1f}/{ts['stall_pct_dma']:.1f}/"
              f"{ts['stall_pct_shadowed']:.1f}/{ts['stall_pct_other']:.1f}")


def _prompts(args, cfg):
    """The requests' prompts, drawn from ``default_rng(0)``: a shared system
    prompt of ``--shared-prefix-len`` tokens, then a suffix of
    ``--prompt-len`` (up to ``--prompt-len-max``) tokens."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, args.shared_prefix_len)
    lens = rng.integers(args.prompt_len,
                        (args.prompt_len_max or args.prompt_len) + 1,
                        args.requests)
    return [np.concatenate([shared, rng.integers(0, cfg.vocab, int(n))])
            .astype(np.int32) for n in lens]


if __name__ == "__main__":
    main()
