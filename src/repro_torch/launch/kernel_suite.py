"""The paper's kernel suite, measured: Fig. 7 (AutoDMA vs handwritten vs
unmodified), the §3.4 ISA study and the attention kernels, on the card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_suite
        [--device cuda|cpu] [--scale N] [--iters N] [--out PATH]

Counterpart of the JAX package's ``benchmarks/bench_autodma.py`` and
``benchmarks/bench_isa.py``, which model these figures (roofline and burst
models of the planner's traffic; interpret-mode wall clock on a CPU). Here
every kernel runs through the port's entry points (``kernels/ops.py``) and
is timed on the device: ``--iters`` calls captured in a CUDA graph and
replayed between CUDA events (:func:`graph_ms`), so the time is the
kernels' and not the host's planning and dispatch:

  * Fig. 7 — gemm 2048³, 2mm and 3mm at N=2048, atax and bicg at N=2048,
    conv2d and covar at N=2048 (``bench_tiling``'s shapes), darknet's
    conv-as-gemm 1024×1024×4608, all f32 (gemm bodies ``mxu``), in modes
    ``unmodified``, ``paper`` and ``autodma`` at the H100 budget
    (``heromem.hero_l1_capacity()``); the gemm family also ``handwritten``
    with :data:`HANDWRITTEN_TILES`. conv2d runs one kernel in every mode
    (as in the reference, the mode changes only its returned plan), and its
    rows say so;
  * ISA study — bodies ``mxu``, ``vpu`` and ``loop`` at ``bench_isa``'s
    sizes (512³, 256×256×1152, 384³), mode ``autodma`` at the H100 budget
    (``bench_isa`` plans with a 1 MiB TPU VMEM budget);
  * a sweep of handwritten tiles at gemm 2048³, from which
    :data:`HANDWRITTEN_TILES` was chosen;
  * attention — ``ops.flash_attention`` at qwen2-0.5b's full width (causal,
    L 2048) and gemma3-27b's local layer (window 1024, L 4096), and the
    dense ``flash_decode`` at the serving path's decode shape (8 slots,
    ragged lengths including 0 and S), bf16 (:data:`ATTENTION`,
    :data:`DECODE`).

Each row prints ms, the speed-up over ``unmodified`` and, for autodma, its
fraction of handwritten, beside the paper's claims (4.4× at most, 85 % of
handwritten, 2.1× from the MAC). The results go to ``--out`` as JSON.

Without a card it fails unless ``--device cpu`` is given; then it runs the
plain grid walker with host-clock times, which are not device times, at
sizes divided by ``--scale`` (default 16 there).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.kernels import decode_attention, ops

# the expert tile for the gemm family on the H100 (tm, tn, tk): a 64×128
# output tile in registers across 16 warps, 128-deep k-steps double-
# buffered (207 KB of shared memory); of SWEEP_TILES (the suite's "sweep"
# rows) the one within 7 % of the fastest at both gemm 2048³ and darknet
HANDWRITTEN_TILES = (64, 128, 128)
SWEEP_TILES = ((128, 128, 32), (128, 128, 64), (64, 128, 64), (128, 64, 64),
               (64, 64, 128), (128, 256, 32), (256, 128, 32), (128, 64, 128),
               (64, 128, 128), (256, 64, 32))
PAPER_CLAIMS = {"max_speedup_vs_unmodified": 4.4,
                "autodma_fraction_of_handwritten": 0.85,
                "isa_mac_speedup_avg": 2.1}
N = 2048
DARKNET = (1024, 1024, 4608)
ISA_SIZES = {"gemm": (512, 512, 512), "darknet": (256, 256, 1152),
             "2mm": (384, 384, 384)}
GEMM_FAMILY = ("gemm", "2mm", "3mm", "darknet")
MODES = ("unmodified", "paper", "autodma")
ONE_KERNEL_EVERY_MODE = ("conv2d",)   # the mode changes only the plan
# (B, H, L, hd, causal, window): full published widths of the configs
ATTENTION = {"qwen2-0.5b": (1, 14, 2048, 64, True, None),
             "gemma3-27b-local": (1, 32, 4096, 128, True, 1024)}
# (B, H, K, S, hd): the serving main path's decode step at max_seq 2048
DECODE = (8, 14, 2, 2048, 64)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def graph_ms(fn: Callable, iters: int) -> float:
    """Device ms per call of ``fn()``: ``iters`` calls captured in one CUDA
    graph after a warm-up call, the graph replayed once to warm it and once
    between CUDA events. Host work (planning, dispatch) stays out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def timer(device: str, iters: int) -> Callable[[Callable], float]:
    """ms per call of ``fn()``: on the card :func:`graph_ms`; on the CPU
    the host clock (not a device time)."""
    def cuda_ms(fn):
        return graph_ms(fn, iters)

    def host_ms(fn):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    return cuda_ms if device == "cuda" else host_ms


def _inputs(device: str, scale: int, seed: int = 0) -> Dict[str, tuple]:
    g = torch.Generator(device=device).manual_seed(seed)
    n = N // scale
    dm, dn, dk = (d // scale for d in DARKNET)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=device)

    return {"gemm": (r(n, n), r(n, n)), "2mm": (r(n, n), r(n, n), r(n, n)),
            "3mm": (r(n, n), r(n, n), r(n, n), r(n, n)),
            "atax": (r(n, n), r(n)), "bicg": (r(n, n), r(n), r(n)),
            "conv2d": (r(n, n), r(3, 3)), "covar": (r(n, n),),
            "darknet": (r(dm, dk), r(dk, dn))}


OPS = {"gemm": ops.gemm, "2mm": ops.mm2, "3mm": ops.mm3, "atax": ops.atax,
       "bicg": ops.bicg, "conv2d": ops.conv2d, "covar": ops.covar,
       "darknet": ops.gemm}


def fig7(device: str, scale: int, iters: int) -> List[dict]:
    ms = timer(device, iters)
    rows = []
    for name, args in _inputs(device, scale).items():
        op = OPS[name]
        times = {m: ms(lambda: op(*args, mode=m)) for m in MODES}
        if name in GEMM_FAMILY:
            tiles = tuple(max(16, t // scale) for t in HANDWRITTEN_TILES)
            times["handwritten"] = ms(lambda: op(*args,
                                                 handwritten_tiles=tiles))
        for mode, t in times.items():
            row = {"kernel": name, "mode": mode, "ms": t,
                   "speedup_vs_unmodified": times["unmodified"] / t,
                   "one_kernel_every_mode": name in ONE_KERNEL_EVERY_MODE}
            if mode == "autodma" and "handwritten" in times:
                row["autodma_fraction_of_handwritten"] = \
                    times["handwritten"] / t
            rows.append(row)
    return rows


def sweep(device: str, scale: int, iters: int) -> List[dict]:
    """gemm 2048³ and darknet (mxu) with each of SWEEP_TILES as handwritten
    tiles: the measurement behind HANDWRITTEN_TILES."""
    ms = timer(device, iters)
    inputs = _inputs(device, scale)
    rows = []
    for name in ("gemm", "darknet"):
        A, B = inputs[name]
        for tiles in SWEEP_TILES:
            t = tuple(max(16, x // scale) for x in tiles)
            rows.append({"kernel": name, "tiles": list(tiles), "ms": ms(
                lambda: ops.gemm(A, B, handwritten_tiles=t))})
    return rows


def isa(device: str, scale: int, iters: int) -> List[dict]:
    ms = timer(device, iters)
    g = torch.Generator(device=device).manual_seed(1)
    rows = []
    for name, (M, Nn, K) in ISA_SIZES.items():
        M, Nn, K = (max(16, d // scale) for d in (M, Nn, K))
        A = torch.randn(M, K, generator=g, device=device)
        B = torch.randn(K, Nn, generator=g, device=device)
        t = {b: ms(lambda: ops.gemm(A, B, body=b)) for b in ("mxu", "vpu",
                                                               "loop")}
        rows.append({"kernel": name, "shape": [M, Nn, K],
                     "ms_mxu": t["mxu"], "ms_vpu": t["vpu"],
                     "ms_loop": t["loop"],
                     "speedup_mac": t["vpu"] / t["mxu"],
                     "speedup_hwloop": t["loop"] / t["mxu"]})
    return rows


def decode_lengths(B: int, S: int, seed: int = 0) -> List[int]:
    """Ragged decode lengths: an empty slot, a full one, and the serving
    mix's (prompts uniform in [128, 1536] plus up to 64 new tokens, cut to
    S)."""
    rng = np.random.default_rng(seed)
    mix = rng.integers(min(128, S), min(1601, S) + 1, max(0, B - 2))
    return ([0, S] + [int(n) for n in mix])[:B]


def attention(device: str, scale: int, iters: int) -> List[dict]:
    """Device ms of ``ops.flash_attention`` at :data:`ATTENTION` and of
    ``flash_decode`` at :data:`DECODE`, bf16, lengths cut by ``scale``."""
    ms = timer(device, iters)
    g = torch.Generator(device=device).manual_seed(2)
    bf16 = torch.bfloat16
    rows = []
    for name, (B, H, L, hd, causal, window) in ATTENTION.items():
        L = max(64, L // scale)
        window = window and max(16, window // scale)
        q, k, v = (torch.randn(B, H, L, hd, generator=g, device=device)
                   .to(bf16) for _ in range(3))
        t = ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                           window=window))
        rows.append({"kernel": "flash_attention", "case": name,
                     "shape": [B, H, L, hd], "causal": causal,
                     "window": window, "dtype": "bfloat16", "ms": t})
    B, H, K, S, hd = DECODE
    S = max(64, S // scale)
    q = torch.randn(B, H, hd, generator=g, device=device).to(bf16)
    kc, vc = (torch.randn(B, K, S, hd, generator=g, device=device).to(bf16)
              for _ in range(2))
    lens = decode_lengths(B, S)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    t = ms(lambda: decode_attention.flash_decode(q, kc, vc, lengths))
    rows.append({"kernel": "flash_decode", "case": "serving decode step",
                 "shape": [B, H, K, S, hd], "lengths": lens,
                 "dtype": "bfloat16", "ms": t})
    return rows


def summary(fig7_rows: List[dict], isa_rows: List[dict]) -> dict:
    auto = [r for r in fig7_rows if r["mode"] == "autodma"]
    fracs = [r["autodma_fraction_of_handwritten"] for r in auto
             if "autodma_fraction_of_handwritten" in r]
    geo = lambda xs: math.exp(sum(math.log(x) for x in xs) / len(xs))
    return {"max_speedup_autodma_vs_unmodified":
            max(r["speedup_vs_unmodified"] for r in auto),
            "geomean_autodma_fraction_of_handwritten": geo(fracs),
            "geomean_isa_mac_speedup": geo([r["speedup_mac"]
                                            for r in isa_rows]),
            "paper_claims": PAPER_CLAIMS}


def run(device: str = "cuda", scale: int = 1, iters: int = 5,
        log: Callable[[str], None] = print) -> dict:
    """Both studies on ``device``; returns what :func:`main` writes."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("kernel_suite: CUDA is not available; pass "
                               "--device cpu to run the plain versions")
        where = f"{torch.cuda.get_device_name(0)} ({card_line()})"
        unit = "ms"
    elif device == "cpu":
        where, unit = "cpu (host clock, plain versions)", "host ms"
    else:
        raise ValueError(f"kernel_suite: unsupported device {device!r}")
    log(f"[kernel_suite] {where}; sizes / {scale}, {iters} timed calls "
        "after a warm-up")
    f7 = fig7(device, scale, iters)
    for r in f7:
        extra = (f", autodma = {r['autodma_fraction_of_handwritten']:.1%} "
                 "of handwritten" if "autodma_fraction_of_handwritten" in r
                 else "")
        if r["one_kernel_every_mode"]:
            extra += " (one kernel in every mode: the mode changes only " \
                "the returned plan)"
        log(f"[kernel_suite:fig7] {r['kernel']:8s} {r['mode']:11s} "
            f"{r['ms']:10.4f} {unit}, {r['speedup_vs_unmodified']:6.2f}x "
            f"vs unmodified{extra}")
    sweep_rows = sweep(device, scale, iters)
    for r in sweep_rows:
        log(f"[kernel_suite:sweep] {r['kernel']} handwritten tiles {r['tiles']}: "
            f"{r['ms']:.4f} {unit}")
    isa_rows = isa(device, scale, iters)
    for r in isa_rows:
        log(f"[kernel_suite:isa] {r['kernel']:8s} {r['shape']}: mxu "
            f"{r['ms_mxu']:.4f}, vpu {r['ms_vpu']:.4f}, loop "
            f"{r['ms_loop']:.4f} {unit}; mac {r['speedup_mac']:.2f}x, "
            f"hwloop {r['speedup_hwloop']:.2f}x")
    att = attention(device, scale, iters)
    for r in att:
        log(f"[kernel_suite:attention] {r['kernel']} {r['case']} "
            f"{r['shape']} {r['dtype']}: {r['ms']:.4f} {unit}")
    s = summary(f7, isa_rows)
    log(f"[kernel_suite:summary] autodma max {s['max_speedup_autodma_vs_unmodified']:.2f}x "
        f"vs unmodified (paper 4.4x), autodma "
        f"{s['geomean_autodma_fraction_of_handwritten']:.1%} of handwritten "
        f"(paper 85%), MAC {s['geomean_isa_mac_speedup']:.2f}x (paper 2.1x)")
    return {"device": where, "time_unit": unit, "scale": scale,
            "iters": iters, "handwritten_tiles": list(HANDWRITTEN_TILES),
            "fig7": f7, "sweep": sweep_rows, "isa": isa_rows,
            "attention": att, "summary": s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=int, default=None,
                    help="divide every size by this (default 1 on cuda, "
                         "16 on cpu)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="BENCH_kernels_torch.json")
    a = ap.parse_args(argv)
    scale = a.scale or (1 if a.device == "cuda" else 16)
    res = run(a.device, scale, a.iters)
    with open(a.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(f"[kernel_suite] wrote {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
