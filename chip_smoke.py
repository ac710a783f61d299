"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line, none catching its own failure:

  1. card      the card's name and power limit (nvidia-smi), torch / CUDA;
  2. build     every hand-written CUDA kernel library, one nvcc each, in
               parallel; each kernel instance's registers and spills;
  3. kernels   each paged attention kernel against its plain PyTorch version
               on the same CUDA tensors (atol 2e-3) at the main path's
               shapes, the smoke shapes, int8 pages, f16 pages and pt 8 /
               hd 128 (bf16), each kernel's grid logged; kernel and
               yardstick times (``scaled_dot_product_attention`` over
               already-gathered dense K/V: it leaves the page walk out and
               is not the same function) from CUDA-graph replays, plain
               times from CUDA events, beside the least time the card could
               take;
  4. suite kernels  the AutoDMA builder with each gemm body (mxu, vpu,
               loop), matvec and matvec_t against the plain grid walker on
               the same CUDA tensors: gemm 2048³ and 1024×1024×4608, matvec
               2048², every mode, bf16, and a ragged shape with a tile that
               does not divide; then conv2d (its own kernel, in its own
               bands) against its row-tile walk at 2048² in every mode,
               bf16, and ragged shapes on the 16-byte path (1001×1500 f32)
               and the scalar path (1001×1500 bf16, 999×1001 f32), f32 bit
               for bit, each path run at least once; and covar (the
               builder's center and gram bodies) against the walker at
               2048² in every mode and a ragged 1000×600; tolerances as
               relative Frobenius error (mxu f32 and covar 5e-3: TF32; vpu
               / loop / matvec f32 1e-5; bf16 1e-2); each matvec / matvec_t
               case also captured in a CUDA graph and replayed twice, bit
               for bit equal to the eager call, and logged with its layout
               (ks, blocks, shared memory) and its kernel instance's
               registers and spills;
               kernel, plain, yardstick (``torch.matmul``
               / ``torch.mv`` / ``F.conv2d`` with a [1,1,3,3] weight and
               padding 1, cuDNN TF32 off / ``torch.cov(D.T)`` under TF32)
               and bound times at the main shapes;
  5. attention kernels  flash_decode at the serving path's decode shape
               (B 8, H 14, K 2, S 2048, hd 64, bf16; ragged lengths from
               the serving mix, a length-0 slot, which must return the
               mean of V, and a full one) and at the reference tests'
               shapes in f32, then captured in a CUDA graph at the main
               shape and replayed twice, bit for bit equal to the eager
               call (its one launch, split grid and in-kernel merge
               logged); flash_attention at qwen2-0.5b's full width
               (B 1, H 14, L 2048, hd 64, bf16, causal), gemma3-27b's
               local layer (B 1, H 32, L 4096, hd 128, bf16, causal,
               window 1024) and small softcap / window / no-key-row /
               ragged cases at hd 32, 64 and 128, each in bf16 (the
               tensor-core kernel) and f32 (the CUDA-core kernel); each
               against its plain version on the same CUDA tensors within
               atol 2e-3, plus one bf16 rounding step of the value for bf16
               outputs (both sides round an f32 result to bf16); kernel,
               plain, ``scaled_dot_product_attention`` yardstick (mask
               stated in the log) and bound times;
  6. suite     the paper's kernel suite through ``kernels/ops.py``
               (``launch/kernel_suite.py``: Fig. 7 at N=2048 with conv2d
               and covar, darknet, the ISA study, the attention rows),
               every kernel launch counted from 0, then each output against
               its oracle;
  7. serve     full-width qwen2-0.5b (random weights, seed 0, bf16) through
               the chunked paged engine: 8 requests, prompts of 128-1536
               tokens, 64 new tokens each; every kernel launch counted;
  8. card/cpu  the smoke config in f32 on the card and on the CPU (asked
               for explicitly) gives equal greedy streams;
  9. a ``{"kernels": [...]}`` line, then the card's name and power limit,
     then ``{"ok": true, "device": {...}}`` as the last line.

Any failure exits non-zero before the last line. Without a card, or run
from a directory that lacks the repository's ``src/``, it fails too.
"""
from __future__ import annotations

import copy
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402,F401  (fails outside a checkout of the repo)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12        # H100 SXM dense TF32 tensor cores
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
TOL = 2e-3
LAYERS = 24                     # qwen2-0.5b depth: timing cycles layer pools


def log(phase: str, msg: str) -> None:
    print(f"[chip_smoke:{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean ms per call of ``fn(i)`` over ``iters`` calls, CUDA events,
    after ``warm`` warm-up calls; ``i`` lets the caller cycle inputs (cold
    L2)."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(bytes_moved: float, flops: float, rate: float = F32_FLOP_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def make_pool(g, P, K, pt, hd, dtype, layers=1):
    kp = torch.randn(layers, P, K, pt, hd, generator=g, device="cuda")
    vp = torch.randn(layers, P, K, pt, hd, generator=g, device="cuda")
    if dtype == torch.int8:
        out = []
        for x in (kp, vp):
            s = x.abs().amax(dim=(-1, -2)) / 127.0          # [layers, P, K]
            qx = torch.round(x / s[..., None, None]).clamp(-127, 127)
            out += [qx.to(torch.int8).contiguous(), s.contiguous()]
        return out
    return [kp.to(dtype).contiguous(), None, vp.to(dtype).contiguous(), None]


def make_tables(lengths, pt, max_pages, P, g):
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(1))
    table = torch.full((len(lengths), max_pages), -1, dtype=torch.int32)
    i = 0
    for b, n in enumerate(lengths):
        need = -(-n // pt)
        table[b, :need] = perm[i:i + need]
        i += need
    return table.cuda()


def check_kernels(results):
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    g = torch.Generator(device="cuda").manual_seed(0)
    dec, pre = results["paged_flash_decode"], results["paged_flash_prefill"]
    cases = [  # name, H, K, hd, pt, page dtype, lengths, max_pages, chunks
        ("main", 14, 2, 64, 16, torch.bfloat16,
         [0, 1, 16, 17, 255, 256, 1000, 2048], 128,
         [(1, 2047), (37, 100), (256, 1500), (256, 0)]),
        ("smoke", 4, 2, 16, 8, torch.float32, [0, 3, 8, 9, 31, 40, 63, 17],
         8, [(1, 0), (3, 5), (8, 56)]),
        ("int8", 14, 2, 64, 16, torch.int8,
         [0, 7, 16, 33, 512, 513, 1999, 2048], 128,
         [(1, 2047), (37, 100), (256, 1500)]),
        ("f16", 14, 2, 64, 16, torch.float16,
         [0, 1, 15, 64, 300, 1024, 1999, 2048], 128,
         [(1, 2047), (37, 100), (256, 1500)]),
        ("pt8-hd128", 14, 2, 128, 8, torch.bfloat16,
         [0, 5, 8, 9, 300, 1001, 1777, 2048], 256,
         [(1, 2047), (37, 100), (256, 1500), (64, 3)]),
    ]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, H, K, hd, pt, dt, lengths, max_pages, chunks in cases:
        B = len(lengths)
        P = sum(-(-n // pt) for n in lengths) + 4
        layers = LAYERS if name == "main" else 1
        kp, ks, vp, vs = make_pool(g, P, K, pt, hd, dt, layers)
        table = make_tables(lengths, pt, max_pages, P, g)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, hd, generator=g, device="cuda")
        sc = (lambda x, i: None if x is None else x[i % layers])

        def dec_call(i, fn=pda.paged_flash_decode):
            return fn(q, kp[i % layers], vp[i % layers], table, lens,
                      k_scale=sc(ks, i), v_scale=sc(vs, i))

        out = dec_call(0)
        torch.cuda.synchronize()
        err = (out - dec_call(0, pda.paged_flash_decode_plain)).abs().max()
        err = err.item()
        assert torch.isfinite(out).all() and err <= TOL, (name, err)
        assert out[0].abs().max().item() == 0.0, "length-0 slot not zero"
        dec["max_abs_err"] = max(dec["max_abs_err"], err)
        grid = pda.decode_grid(B, H, K, hd, max_pages, n_sm)
        log("kernels", f"decode {name}: B {B} H {H} K {K} hd {hd} pt {pt} "
            f"{str(dt)[6:]} pages, {grid.nsplit} splits of "
            f"{grid.pages_per_split} pages, {grid.blocks} blocks + merge "
            f"{B * H}, max |kernel - plain| {err:.3e}")
        if name == "main":
            assert grid.blocks >= n_sm, grid
        if name == "main":
            time_decode(dec, dec_call, q, kp, vp, table, lens, lengths, K,
                        pt, hd, layers)
        row = table[int(np.argmax(lengths))]  # the longest sequence's pages
        for C, start in chunks:
            q2 = torch.randn(C, H, hd, generator=g, device="cuda")

            def pre_call(i, fn=ppa.paged_flash_prefill):
                return fn(q2, kp[i % layers], vp[i % layers], row, start,
                          k_scale=sc(ks, i), v_scale=sc(vs, i))

            out = pre_call(0)
            torch.cuda.synchronize()
            err = (out - pre_call(0, ppa.paged_flash_prefill_plain)).abs()
            err = err.max().item()
            assert torch.isfinite(out).all() and err <= TOL, (name, C, err)
            pre["max_abs_err"] = max(pre["max_abs_err"], err)
            grid = ppa.prefill_grid(C, H, K, hd, pt, max_pages, start, n_sm,
                                    dt)
            kind = ("tensor cores" if dt in ppa.TENSOR_CORE_DTYPES
                    else "CUDA cores")
            log("kernels", f"prefill {name}: C {C} start {start}, {kind}, "
                f"{grid.nsplit} splits of {grid.tiles_per_split} key tiles, "
                f"{grid.blocks} blocks"
                f"{f' + merge {C * H}' if grid.nsplit > 1 else ''}, max "
                f"|kernel - plain| {err:.3e}")
            if name == "main" and (C, start) == (256, 1500):
                assert grid.blocks >= n_sm, grid
                time_prefill(pre, pre_call, q2, kp, vp, row, start, K, pt,
                             hd, layers)


def time_decode(res, call, q, kp, vp, table, lens, lengths, K, pt, hd,
                layers):
    """Kernel and the SDPA yardstick: device time of 20 calls replayed from
    one CUDA graph (kernel_suite.graph_ms), cycling the layer pools; plain:
    CUDA events around eager calls."""
    import itertools
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch.kernel_suite import graph_ms
    B, H, _ = q.shape
    G = H // K
    cyc = itertools.cycle(range(layers))
    res["ms"] = graph_ms(lambda: call(next(cyc)), 20)
    res["plain_ms"] = cuda_ms(lambda i: call(i, pda.paged_flash_decode_plain))
    # yardstick: SDPA over K/V gathered dense beforehand (no page walk)
    S = table.shape[1] * pt
    kd = [pda.gather_pages(kp[i], table) for i in range(layers)]
    vd = [pda.gather_pages(vp[i], table) for i in range(layers)]
    qb = q.to(kp.dtype)[:, :, None]                        # [B, H, 1, hd]
    mask = (torch.arange(S, device="cuda")[None] <
            lens[:, None])[:, None, None]

    def sdpa(i):
        return F.scaled_dot_product_attention(qb, kd[i], vd[i],
                                              attn_mask=mask, enable_gqa=True)

    res["library_ms"] = graph_ms(lambda: sdpa(next(cyc)), 20)
    page_rows = sum(-(-n // pt) * pt for n in lengths)
    nbytes = (K * page_rows * hd * 2 * kp.element_size()
              + 2 * q.numel() * 4 + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * G * K * hd * sum(lengths)
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    log("kernels", f"decode main timing: kernel (graph) {res['ms']:.4f} "
        f"ms, plain {res['plain_ms']:.4f} ms, sdpa yardstick (graph) "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {nbytes} B at 3.35 TB/s, {flops} flop at 67 "
        "TFLOP/s f32)")


def time_prefill(res, call, q, kp, vp, row, start, K, pt, hd, layers):
    """Timed as :func:`time_decode`; the bound takes the bf16 tensor-core
    rate for bf16 pages, which the kernel multiplies on tensor cores."""
    import itertools
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.kernel_suite import graph_ms
    C, H, _ = q.shape
    cyc = itertools.cycle(range(layers))
    res["ms"] = graph_ms(lambda: call(next(cyc)), 20)
    res["plain_ms"] = cuda_ms(lambda i: call(i,
                                             ppa.paged_flash_prefill_plain))
    kd = [pda.gather_pages(kp[i], row[None]) for i in range(layers)]
    vd = [pda.gather_pages(vp[i], row[None]) for i in range(layers)]
    S = row.shape[0] * pt
    qb = q.to(kp.dtype).transpose(0, 1)[None]              # [1, H, C, hd]
    mask = (torch.arange(S, device="cuda")[None] <=
            start + torch.arange(C, device="cuda")[:, None])

    def sdpa(i):
        return F.scaled_dot_product_attention(qb, kd[i], vd[i],
                                              attn_mask=mask, enable_gqa=True)

    res["library_ms"] = graph_ms(lambda: sdpa(next(cyc)), 20)
    rows = -(-(start + C) // pt) * pt
    nbytes = (K * rows * hd * 2 * kp.element_size() + 2 * q.numel() * 4
              + row.numel() * 4)
    flops = 4 * H * hd * sum(start + c + 1 for c in range(C))
    assert kp.dtype == torch.bfloat16, "the rate below is bf16's"
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    log("kernels", f"prefill main timing (C {C}, start {start}): kernel "
        f"(graph) {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, sdpa "
        f"yardstick (graph) {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {nbytes} B at 3.35 "
        f"TB/s, {flops} flop at 989 TFLOP/s bf16)")


# --------------------------------------------------------------------------
# phases 4 and 5: the AutoDMA kernel suite
# --------------------------------------------------------------------------
SUITE_MODES = ("unmodified", "paper", "autodma", "handwritten")
RAGGED_MODES = ("unmodified", "autodma", "handwritten")
RAGGED_GEMM, RAGGED_MATVEC = (1000, 600, 1100), (1000, 1500)
RAGGED_CONV, RAGGED_COVAR = (1001, 1500), (1000, 600)
RAGGED_CONV_SCALAR = (999, 1001)   # f32 W % 4 = 1; RAGGED_CONV bf16 W % 8 = 4
BODIES = ("mxu", "vpu", "loop")
BF16_TOL = 1e-2                 # bf16 output rounded every reduction step
MXU_F32_TOL = 5e-3              # TF32 operands: a 10-bit mantissa
F32_TOL = 1e-5                  # f32 sums taken in another order


def rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def hold(rows, out, ref, tol, what):
    """Fail unless ``out`` is finite and within ``tol`` (relative Frobenius)
    of ``ref``; record the max abs error on every row in ``rows``."""
    err = rel_err(out, ref)
    abs_err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all() and err <= tol, (what, err, tol)
    for r in rows:
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
    log("suite kernels", f"{what}: rel err {err:.2e} (tol {tol:g}), max "
        f"|kernel - plain| {abs_err:.3e}")


def replay_equals_eager(call, eager, what, phase="suite kernels"):
    """Fail unless ``call()`` captured in a CUDA graph and replayed twice
    gives ``eager`` bit for bit (graph safety, run-to-run determinism)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), (what, "graph replay")
    log(phase, f"{what}: two graph replays equal the eager call bit for "
        "bit")


def check_suite_kernels(results):
    import functools
    from repro_torch.core import autodma
    from repro_torch.kernels import gemm as tg
    from repro_torch.kernels import polybench as pb
    from repro_torch.kernels import tiled
    from repro_torch.launch.kernel_suite import HANDWRITTEN_TILES
    g = torch.Generator(device="cuda").manual_seed(2)
    builder = results["autodma_tiled"]
    f32, bf16 = torch.float32, torch.bfloat16
    gemm_cases = [  # shape, dtype, alpha, bodies, modes, handwritten tiles
        ((2048, 2048, 2048), f32, 1.0, BODIES, SUITE_MODES,
         HANDWRITTEN_TILES),
        ((1024, 1024, 4608), f32, 1.0, BODIES, SUITE_MODES,
         HANDWRITTEN_TILES),
        ((2048, 2048, 2048), bf16, 1.0, ("mxu",), SUITE_MODES,
         HANDWRITTEN_TILES),
        ((2048, 2048, 2048), bf16, 1.0, ("vpu", "loop"), ("autodma",), None),
        # ragged: no tile divides 1000 x 600 x 1100, so autodma degrades to
        # granule tiles and the last block of every axis is short; paper's
        # rule falls back to whole axes, which shared memory cannot hold
        (RAGGED_GEMM, f32, 0.5, BODIES, RAGGED_MODES, (48, 80, 96)),
        (RAGGED_GEMM, bf16, 0.5, BODIES, RAGGED_MODES, (48, 80, 96)),
    ]
    for (M, N, K), dt, alpha, bodies, modes, hw in gemm_cases:
        A = torch.randn(M, K, generator=g, device="cuda").to(dt)
        B = torch.randn(K, N, generator=g, device="cuda").to(dt)
        for body in bodies:
            tol = BF16_TOL if dt == bf16 else (
                MXU_F32_TOL if body == "mxu" else F32_TOL)
            for mode in modes:
                kw = (dict(handwritten_tiles=hw) if mode == "handwritten"
                      else dict(mode=mode))
                out, plan = tg.gemm(A, B, alpha=alpha, body=body, **kw)
                torch.cuda.synchronize()
                plain = autodma.walk(functools.partial(
                    tg.BODIES[body], alpha=alpha), plan, A, B)
                hold([builder, results["gemm"]], out, plain, tol,
                     f"gemm {M}x{N}x{K} {str(dt)[6:]} {body} {mode} tiles "
                     f"{plan.tiles}")
        if (M, N, K) == RAGGED_GEMM:  # a plan over the limit: raise, no fallback
            try:
                tg.gemm(A, B, mode="paper")
            except ValueError as e:
                log("suite kernels", f"gemm {M}x{N}x{K} paper refused: {e}")
            else:
                raise AssertionError("an over-budget plan was launched")
    bodies = {"matvec": pb._matvec_body, "matvec_t": pb._matvec_t_body}
    for (M, N), dt, modes in [((2048, 2048), f32, SUITE_MODES[:3]),
                              ((2048, 2048), bf16, SUITE_MODES[:3]),
                              (RAGGED_MATVEC, f32, RAGGED_MODES[:2])]:
        A = torch.randn(M, N, generator=g, device="cuda").to(dt)
        x = torch.randn(N, generator=g, device="cuda").to(dt)
        xt = torch.randn(M, generator=g, device="cuda").to(dt)
        for name, v in (("matvec", x), ("matvec_t", xt)):
            if (M, N) == RAGGED_MATVEC:
                try:
                    getattr(pb, name)(A, v, mode="paper")
                except ValueError as e:
                    log("suite kernels", f"{name} {M}x{N} paper refused: {e}")
                else:
                    raise AssertionError("an over-budget plan was launched")
            for mode in modes:
                y, plan = getattr(pb, name)(A, v, mode=mode)
                torch.cuda.synchronize()
                plain = autodma.walk(bodies[name], plan, A, v)
                what = f"{name} {M}x{N} {str(dt)[6:]} {mode}"
                hold([builder, results[name]], y, plain,
                     BF16_TOL if dt == bf16 else F32_TOL,
                     f"{what} tiles {plan.tiles}")
                replay_equals_eager(lambda: getattr(pb, name)(A, v,
                                                              mode=mode)[0],
                                    y, what)
                lay = tiled.layout(name, plan)
                inst = (f"{name} {'f32' if dt == f32 else 'bf16'} "
                        f"{'staged' if lay['staged'] else 'unstaged'}")
                log("suite kernels", f"{what}: {lay['blocks']} tiles x ks "
                    f"{lay['ks']} = {lay['blocks'] * lay['ks']} blocks of "
                    f"{lay['threads']} threads, {lay['smem']} B shared "
                    f"memory; {inst}: {INSTANCES.get(inst, 'not built here')}")
    c = torch.randn(3, 3, generator=g, device="cuda")
    paths = set()
    for (H, W), dt, modes in [((2048, 2048), f32, SUITE_MODES[:3]),
                              ((2048, 2048), bf16, ("autodma",)),
                              (RAGGED_CONV, f32, ("autodma",)),
                              (RAGGED_CONV, bf16, ("autodma",)),
                              (RAGGED_CONV_SCALAR, f32, ("autodma",))]:
        A = torch.randn(H, W, generator=g, device="cuda").to(dt)
        plain = pb.conv2d_plain(A, c, pb.conv2d_row_tile(H, W))
        shape = pb.conv2d_launch(H, W, dt)
        path = "16-byte" if shape.vec > 1 else "scalar"
        paths.add(path)
        inst = f"conv2d {'f32' if dt == f32 else 'bf16'} vec {shape.vec}"
        for mode in modes:   # one kernel in every mode: the plan changes
            out, plan = pb.conv2d(A, c, mode=mode)
            torch.cuda.synchronize()
            what = (f"conv2d {H}x{W} {str(dt)[6:]} {mode} (row tile "
                    f"{pb.conv2d_row_tile(H, W)}, plan tiles {plan.tiles}; "
                    f"{path} path: bands of {shape.band} rows, "
                    f"{shape.blocks} blocks; {inst}: "
                    f"{INSTANCES.get(inst, 'not built here')})")
            hold([results["conv2d"]], out, plain,
                 BF16_TOL if dt == bf16 else F32_TOL, what)
            if dt == f32:    # the same products and sums: the same bits
                assert torch.equal(out, plain), (what, "not bit for bit")
                log("suite kernels", f"conv2d {H}x{W} f32 {mode}: equal to "
                    "the row-tile walk bit for bit")
    assert paths == {"16-byte", "scalar"}, paths
    for (M, N), modes in [((2048, 2048), SUITE_MODES[:3]),
                          (RAGGED_COVAR, RAGGED_MODES[:2])]:
        D = torch.randn(M, N, generator=g, device="cuda")
        if (M, N) == RAGGED_COVAR:   # paper's whole-axis blocks: must raise
            try:
                pb.covar(D, mode="paper")
            except ValueError as e:
                log("suite kernels", f"covar {M}x{N} paper refused: {e}")
            else:
                raise AssertionError("an over-budget plan was launched")
        for mode in modes:
            out, (p1, p2) = pb.covar(D, mode=mode)
            torch.cuda.synchronize()
            plain = pb.covar_plain(D, p1, p2)
            hold([builder, results["covar"]], out, plain, MXU_F32_TOL,
                 f"covar {M}x{N} f32 {mode} tiles {p1.tiles} / {p2.tiles}")
    torch.cuda.synchronize()
    time_suite_kernels(results)


def _library_tf32(fn):
    """Time a yardstick under TF32, as the mxu body computes."""
    from repro_torch.launch.kernel_suite import graph_ms
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return graph_ms(fn, 20)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def time_suite_kernels(results):
    """Kernel and yardstick: device time of 20 calls replayed from a CUDA
    graph (kernel_suite.graph_ms), as the kernel suite times (torch.cov,
    which waits on the host, with CUDA events around eager calls); plain:
    CUDA events around calls of the grid walker, whose many small launches
    the host issues one by one."""
    import functools
    import itertools
    from repro_torch.core import autodma
    from repro_torch.kernels import gemm as tg
    from repro_torch.kernels import polybench as pb
    from repro_torch.kernels import tiled
    from repro_torch.launch.kernel_suite import graph_ms
    g = torch.Generator(device="cuda").manual_seed(3)
    mxu = functools.partial(tg.BODIES["mxu"], alpha=1.0)
    # gemm 2048^3 (autodma, mxu) and the builder at darknet's conv-as-gemm
    for name, (M, N, K) in (("gemm", (2048, 2048, 2048)),
                            ("autodma_tiled", (1024, 1024, 4608))):
        res = results[name]
        A = torch.randn(M, K, generator=g, device="cuda")
        B = torch.randn(K, N, generator=g, device="cuda")
        if name == "gemm":
            _, plan = tg.gemm(A, B)
            res["ms"] = graph_ms(lambda: tg.gemm(A, B), 20)
        else:
            call, plan = autodma.tiled_call(
                autodma.Body("gemm_mxu", mxu), autodma.matmul_spec(M, N, K))
            res["ms"] = graph_ms(lambda: call(A, B), 20)
        res["plain_ms"] = cuda_ms(lambda i: autodma.walk(mxu, plan, A, B),
                                  iters=2, warm=1)
        res["library_ms"] = _library_tf32(lambda: torch.matmul(A, B))
        nbytes = (M * K + K * N + M * N) * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, 2 * M * N * K,
                                                 TF32_FLOP_PER_S)
        lay = tiled.layout("gemm_mxu", plan)
        log("suite kernels", f"{name} {M}x{N}x{K} f32 mxu autodma tiles "
            f"{plan.tiles} ({lay['threads'] // 32} warps of "
            f"{16 * lay['fpw']}x32, {lay['npass']} pass): kernel "
            f"{res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, torch.matmul (TF32) yardstick "
            f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}: {nbytes} B at 3.35 TB/s, "
            f"{2 * M * N * K} flop at 495 TFLOP/s TF32)")
    # matvec / matvec_t at 2048^2, cycling 4 matrices (64 MB > 50 MB L2)
    M = N = 2048
    As = [torch.randn(M, N, generator=g, device="cuda") for _ in range(4)]
    x = torch.randn(N, generator=g, device="cuda")
    for name, body, lib in (
            ("matvec", pb._matvec_body, lambda a: torch.mv(a, x)),
            ("matvec_t", pb._matvec_t_body, lambda a: torch.mv(a.t(), x))):
        res, fn = results[name], getattr(pb, name)
        _, plan = fn(As[0], x)
        cycle = itertools.cycle(As)     # each captured call reads the next
        res["ms"] = graph_ms(lambda: fn(next(cycle), x), 20)
        res["plain_ms"] = cuda_ms(
            lambda i: autodma.walk(body, plan, As[i % 4], x), iters=4,
            warm=1)
        res["library_ms"] = graph_ms(lambda: lib(next(cycle)), 20)
        nbytes = (M * N + M + N) * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, 2 * M * N)
        log("suite kernels", f"{name} {M}x{N} f32 autodma tiles "
            f"{plan.tiles}: kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, torch.mv yardstick "
            f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}: {nbytes} B at 3.35 TB/s)")
    # conv2d at 2048^2 f32 (row tile 8), cycling the 4 matrices
    cycle = itertools.cycle(As)
    res = results["conv2d"]
    c = torch.randn(3, 3, generator=g, device="cuda")
    bh = pb.conv2d_row_tile(M, N)
    res["ms"] = graph_ms(lambda: pb.conv2d(next(cycle), c), 20)
    res["plain_ms"] = cuda_ms(lambda i: pb.conv2d_plain(As[i % 4], c, bh),
                              iters=2, warm=1)
    w = c[None, None].contiguous()                         # [1, 1, 3, 3]
    res["library_ms"] = graph_ms(
        lambda: F.conv2d(next(cycle)[None, None], w, padding=1), 20)
    nbytes = 2 * M * N * 4 + 9 * 4
    res["bound_ms"], res["bound_by"] = bound(nbytes, 18 * M * N)
    shape = pb.conv2d_launch(M, N)
    log("suite kernels", f"conv2d {M}x{N} f32 row tile {bh} (kernel: bands "
        f"of {shape.band} rows, {shape.blocks} blocks): kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, F.conv2d "
        f"(cuDNN, TF32 off) yardstick {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {nbytes} B at 3.35 "
        f"TB/s, {18 * M * N} flop at 67 TFLOP/s f32)")
    # covar at 2048^2 f32, autodma: mean, center, gram (TF32)
    res = results["covar"]
    _, (p1, p2) = pb.covar(As[0])
    res["ms"] = graph_ms(lambda: pb.covar(next(cycle)), 20)
    res["plain_ms"] = cuda_ms(lambda i: pb.covar_plain(As[i % 4], p1, p2),
                              iters=1, warm=1)
    # torch.cov waits on the host inside, so it cannot be graphed: CUDA
    # events around eager calls, under TF32 as the gram computes
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        res["library_ms"] = cuda_ms(lambda i: torch.cov(As[i % 4].T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    nbytes = (M * N + N * N) * 4
    flops = 2 * N * N * M
    t_ops = (flops / TF32_FLOP_PER_S + 2 * M * N / F32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    res["bound_ms"], res["bound_by"] = ((t_ops, "operations")
                                        if t_ops >= t_bytes
                                        else (t_bytes, "bytes"))
    log("suite kernels", f"covar {M}x{N} f32 autodma tiles {p1.tiles} / "
        f"{p2.tiles}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, torch.cov (TF32, eager) yardstick "
        f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {flops} flop at 495 TFLOP/s TF32 + "
        f"{2 * M * N} at 67 TFLOP/s f32; {nbytes} B at 3.35 TB/s)")


# --------------------------------------------------------------------------
# phase 5: the attention kernels against their plain versions
# --------------------------------------------------------------------------
def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x|: 2^(e - 7) for |x| in [2^e,
    2^(e+1)) (2^-8 to 2^-7 of |x|), 0 at 0."""
    x = x.float().abs()
    e = torch.floor(torch.log2(x.clamp_min(2.0**-126)))
    return torch.where(x > 0, torch.exp2(e - 7), 0.0)


def close(out, plain, tol: float = TOL) -> float:
    """Fail unless ``out`` is finite and within ``tol`` of ``plain`` plus,
    for bf16, one bf16 rounding step of the value (both sides round an f32
    result to bf16: two f32 values a few ulp apart on either side of a
    midpoint land one step apart); returns max |diff|."""
    diff = (out.float() - plain.float()).abs()
    lim = tol + (bf16_step(plain) if plain.dtype == torch.bfloat16 else 0.0)
    assert torch.isfinite(out.float()).all() and bool((diff <= lim).all()), \
        (diff.max().item(), tol)
    return diff.max().item()


def check_attention_kernels(results):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.kernel_suite import (ATTENTION, DECODE,
                                                 decode_lengths)
    g = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    dec, att = results["flash_decode"], results["flash_attention"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    B, H, K, S, hd = DECODE
    main_lens = decode_lengths(B, S)
    cases = [((B, H, K, S, hd), bf16, main_lens),
             ((B, H, K, S, hd), f32, main_lens),
             ((2, 8, 2, 256, 64), f32, [0, 200]),
             ((1, 4, 4, 512, 128), f32, [512]),
             ((3, 6, 3, 384, 64), f32, [383, 0, 17]),
             ((2, 4, 2, 100, 32), bf16, [0, 99])]
    for (B_, H_, K_, S_, hd_), dt, lens in cases:
        q = torch.randn(B_, H_, hd_, generator=g, device="cuda").to(dt)
        kc, vc = (torch.randn(B_, K_, S_, hd_, generator=g, device="cuda")
                  .to(dt) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = da.flash_decode(q, kc, vc, lengths)
        torch.cuda.synchronize()
        err = close(out, da.flash_decode_plain(q, kc, vc, lengths))
        for b in [i for i, n in enumerate(lens) if n == 0]:
            mean_v = vc[b].float().mean(dim=1).repeat_interleave(H_ // K_, 0)
            close(out[b], mean_v.to(dt))
        dec["max_abs_err"] = max(dec["max_abs_err"], err)
        launch = da.decode_launch(B_, H_, K_, S_, hd_, n_sm)
        log("attention kernels", f"flash_decode B {B_} H {H_} K {K_} S {S_} "
            f"hd {hd_} {str(dt)[6:]} lengths {lens}: one launch of "
            f"{launch.nsplit} splits of {launch.chunk} keys x {B_ * K_} "
            f"(slot, kv head) x {launch.groups} row groups = "
            f"{launch.blocks} blocks, merged by the last block of each; "
            f"max |kernel - plain| {err:.3e}")
        if (B_, H_, K_, S_, hd_) == DECODE and dt == bf16:
            inst = f"flash_decode bf16 hd {hd_}"
            n0 = da.flash_decode.launches
            replay_equals_eager(lambda: da.flash_decode(q, kc, vc, lengths),
                                out, f"flash_decode main shape bf16 "
                                f"({launch.blocks} blocks, "
                                f"{launch.blocks / n_sm:.2f} an SM; {inst}: "
                                f"{INSTANCES.get(inst, 'not built here')})",
                                "attention kernels")
            assert da.flash_decode.launches == n0 + 1, "one launch a call"
    time_decode_dense(dec, DECODE, main_lens, g)
    small = [  # (B, H, L, Lk, hd), causal, window, softcap; bf16 and f32
        ((2, 4, 256, 256, 32), False, None, 20.0),
        ((2, 4, 128, 128, 128), True, 64, 20.0),
        ((1, 2, 256, 256, 64), False, 48, 5.0),
        ((1, 2, 256, 128, 64), True, 32, None),    # rows that see no key
        ((1, 2, 200, 130, 64), False, None, None),
        ((1, 3, 300, 300, 32), True, None, None),
        ((1, 2, 384, 384, 128), True, 100, None)]
    main = [((B_, H_, L, L, hd_), causal, window, None, bf16)
            for B_, H_, L, hd_, causal, window in ATTENTION.values()]
    cases = main + [c + (dt,) for c in small for dt in (bf16, f32)]
    for (B_, H_, L, Lk, hd_), causal, window, softcap, dt in cases:
        q = torch.randn(B_, H_, L, hd_, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(B_, H_, Lk, hd_, generator=g, device="cuda")
                .to(dt) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = close(out, fa.flash_attention_plain(q, k, v, **kw))
        att["max_abs_err"] = max(att["max_abs_err"], err)
        shape = fa.launch_shape(L, hd_, dt)
        log("attention kernels", f"flash_attention B {B_} H {H_} L {L} Lk "
            f"{Lk} hd {hd_} {str(dt)[6:]} causal {causal} window {window} "
            f"softcap {softcap}: "
            f"{'tensor cores' if dt == bf16 else 'CUDA cores'}, "
            f"{shape.blocks * B_ * H_} blocks of {shape.threads} threads, "
            f"{shape.smem} B shared; max |kernel - plain| {err:.3e}")
        if (B_, H_, L, Lk, hd_) == (1, 14, 2048, 2048, 64):
            time_flash(att, q, k, v, causal, window)
        elif Lk == L and L >= 4096:
            time_flash({}, q, k, v, causal, window)


def time_decode_dense(res, shape, lens, g):
    """Kernel and the SDPA yardstick: device time of 20 calls replayed from
    a CUDA graph, cycling 8 caches (67 MB > the 50 MB L2); plain: CUDA
    events around eager calls."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.kernel_suite import graph_ms
    import itertools
    B, H, K, S, hd = shape
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(torch.bfloat16)
    caches = [tuple(torch.randn(B, K, S, hd, generator=g, device="cuda")
                    .to(torch.bfloat16) for _ in range(2)) for _ in range(8)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cyc = itertools.cycle(caches)
    res["ms"] = graph_ms(lambda: da.flash_decode(q, *next(cyc), lengths), 20)
    res["plain_ms"] = cuda_ms(lambda i: da.flash_decode_plain(
        q, *caches[i % 8], lengths), iters=4, warm=1)
    qb = q[:, :, None]                                     # [B, H, 1, hd]
    mask = (torch.arange(S, device="cuda")[None] <
            lengths[:, None])[:, None, None]               # key pos < length
    res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qb, *next(cyc), attn_mask=mask, enable_gqa=True), 20)
    G, item = H // K, 2
    nbytes = (sum(K * hd * item * (n + (n if n > 0 else S)) for n in lens)
              + 2 * q.numel() * item + 4 * B)
    flops = sum(K * G * hd * (4 * n if n > 0 else 2 * S) for n in lens)
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    log("attention kernels", f"flash_decode timing B {B} H {H} K {K} S {S} "
        f"hd {hd} bf16 lengths {lens}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, sdpa yardstick (graph; mask: key "
        f"position < length) {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms "
        f"({res['bound_by']}: {nbytes} B at 3.35 TB/s, {flops} flop at 989 "
        "TFLOP/s bf16)")


def time_flash(res, q, k, v, causal, window):
    """Kernel and the SDPA yardstick: device time of 20 calls replayed from
    a CUDA graph; plain (the block walk): CUDA events around eager calls."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.kernel_suite import graph_ms
    B, H, L, hd = q.shape
    assert causal, "the pair count below is the causal one"
    res["ms"] = graph_ms(lambda: fa.flash_attention(
        q, k, v, causal=causal, window=window), 20)
    res["plain_ms"] = cuda_ms(lambda i: fa.flash_attention_plain(
        q, k, v, causal=causal, window=window), iters=2, warm=1)
    if window is None:
        what = "is_causal=True"
        res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 20)
    else:
        i = torch.arange(L, device="cuda")
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        what = f"bool [L, L] mask, causal and window {window}"
        res["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 20)
    pairs = sum(min(n + 1, window or n + 1) for n in range(L))
    flops = 4 * hd * pairs * B * H
    nbytes = 4 * q.numel() * q.element_size()
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    log("attention kernels", f"flash_attention timing B {B} H {H} L {L} hd "
        f"{hd} bf16 causal {causal} window {window}: kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, sdpa "
        f"yardstick (graph, {what}) {res['library_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {flops} flop at 989 "
        f"TFLOP/s bf16, {nbytes} B at 3.35 TB/s)")


def suite_main_path(results):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as tg
    from repro_torch.kernels import ops
    from repro_torch.kernels import polybench as pb
    from repro_torch.kernels import ref
    from repro_torch.kernels import tiled
    from repro_torch.launch import kernel_suite
    counters = {"autodma_tiled": tiled.launch, "gemm": tg.gemm,
                "matvec": pb.matvec, "matvec_t": pb.matvec_t,
                "conv2d": pb.conv2d, "covar": pb.covar,
                "flash_attention": fa.flash_attention,
                "flash_decode": da.flash_decode}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = kernel_suite.run("cuda", 1, iters=3,
                           log=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    assert all(n > 0 for n in counts.values()), counts
    assert counts["autodma_tiled"] == (counts["gemm"] + counts["matvec"]
                                       + counts["matvec_t"]
                                       + 2 * counts["covar"]), counts
    for name, n in counts.items():
        results[name]["launches"] = n
    log("suite", f"{len(res['fig7'])} Fig. 7 rows, {len(res['isa'])} ISA "
        f"rows and {len(res['attention'])} attention rows in {wall:.1f} s; "
        f"launches {counts}")
    log("suite", json.dumps({"fig7": res["fig7"], "isa": res["isa"],
                             "attention": res["attention"],
                             "summary": res["summary"]}))
    # what comes out is right: each Fig. 7 kernel (autodma) against its
    # oracle in f32; the mxu products run in TF32, 3mm chains three
    g = torch.Generator(device="cuda").manual_seed(4)
    n = kernel_suite.N
    A, B, C, D = (torch.randn(n, n, generator=g, device="cuda")
                  for _ in range(4))
    x, r = (torch.randn(n, generator=g, device="cuda") for _ in range(2))
    Ad = torch.randn(1024, 4608, generator=g, device="cuda")
    Bd = torch.randn(4608, 1024, generator=g, device="cuda")
    checks = [("gemm", ops.gemm(A, B), ops.REFS["gemm"](A, B), MXU_F32_TOL),
              ("2mm", ops.mm2(A, B, C), ops.REFS["mm2"](A, B, C),
               2 * MXU_F32_TOL),
              ("3mm", ops.mm3(A, B, C, D), ops.REFS["mm3"](A, B, C, D),
               3 * MXU_F32_TOL),
              ("atax", ops.atax(A, x), ops.REFS["atax"](A, x), F32_TOL),
              ("darknet", ops.gemm(Ad, Bd), ops.REFS["gemm"](Ad, Bd),
               MXU_F32_TOL)]
    c = torch.randn(3, 3, generator=g, device="cuda")
    checks += [("conv2d", ops.conv2d(A, c), ops.REFS["conv2d"](A, c),
                F32_TOL),
               ("covar", ops.covar(A), ops.REFS["covar"](A), MXU_F32_TOL)]
    for got, exp in zip(ops.bicg(A, x, r), ops.REFS["bicg"](A, x, r)):
        checks.append(("bicg", got, exp, F32_TOL))
    for name, got, exp, tol in checks:
        err = rel_err(got, exp)
        assert tuple(got.shape) == tuple(exp.shape) and \
            torch.isfinite(got).all() and err <= tol, (name, err)
        log("suite", f"{name} (autodma) against its oracle: rel err "
            f"{err:.2e} (tol {tol:g})")
    # the attention kernels against their oracles, f32, within 2e-3
    q, k, v = (torch.randn(1, 14, 512, 64, generator=g, device="cuda")
               for _ in range(3))
    B, H, K, S, hd = kernel_suite.DECODE
    qd = torch.randn(B, H, hd, generator=g, device="cuda")
    kc, vc = (torch.randn(B, K, S, hd, generator=g, device="cuda")
              for _ in range(2))
    lens = torch.tensor(kernel_suite.decode_lengths(B, S), dtype=torch.int32,
                        device="cuda")
    for name, got, exp in [
            ("flash_attention", ops.flash_attention(q, k, v, window=128),
             ops.REFS["flash_attention"](q, k, v, window=128)),
            ("flash_decode", da.flash_decode(qd, kc, vc, lens),
             ref.decode_attention(qd, kc, vc, lens))]:
        err = (got - exp).abs().max().item()
        assert tuple(got.shape) == tuple(exp.shape) and \
            torch.isfinite(got).all() and err <= TOL, (name, err)
        log("suite", f"{name} against its oracle (f32): max abs err "
            f"{err:.2e} (tol {TOL:g})")


# --------------------------------------------------------------------------
# phases 6 and 7: the engine
# --------------------------------------------------------------------------
def serve(engine, prompts, max_new):
    from repro_torch.serve.engine import Request
    for i, p in enumerate(prompts):
        assert engine.submit(Request(seq_id=i, prompt=p.copy(),
                                     max_new=max_new))
    done = engine.run(max_steps=100000)
    torch.cuda.synchronize()
    assert engine.idle and len(done) == len(prompts), "requests unfinished"
    return {r.seq_id: list(r.tokens_out) for r in done}


def full_width_serve(results, card: str):
    from repro_torch import configs
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch.serve import warm_up
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    cfg = configs.get_config("qwen2-0.5b")                 # bf16 compute
    t0 = time.perf_counter()
    model = transformer.init_model(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    conf = EngineConfig(n_slots=8, max_seq=2048, chunked=True,
                        token_budget=256,
                        cache=CacheConfig(page_tokens=16))
    warm_up(cfg, model, conf, "cuda")
    eng = Engine(cfg, model, config=conf, device="cuda")
    torch.cuda.synchronize()
    log("serve", f"set-up {time.perf_counter() - t0:.2f} s: qwen2-0.5b "
        f"{cfg.n_layers()} layers d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv} vocab {cfg.vocab}, "
        f"{transformer.count_params(eng.model)} parameters in "
        f"{eng.model.embed.dtype}")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1537, 8)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]
    pda.paged_flash_decode.launches = 0
    ppa.paged_flash_prefill.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = serve(eng, prompts, 64)
    wall = time.perf_counter() - t0
    n_dec = pda.paged_flash_decode.launches
    n_pre = ppa.paged_flash_prefill.launches
    s = eng.stats_summary()
    assert all(len(t) == 64 for t in streams.values())
    assert s["prefill_chunk_tokens"] == int(lens.sum()), s
    assert s["max_iter_tokens"] <= s["token_budget"]
    assert eng.pool.alloc.free_pages == eng.pool.alloc.n_pages
    eng.pool.alloc.audit()
    assert n_dec == cfg.n_layers() * s["decode_steps"] > 0, (n_dec, s)
    assert n_pre == cfg.n_layers() * s["prefill_chunks"] > 0, (n_pre, s)
    results["paged_flash_decode"]["launches"] = n_dec
    results["paged_flash_prefill"]["launches"] = n_pre
    toks = sum(len(t) for t in streams.values())
    log("serve", f"{card}: {len(streams)} requests, prompts "
        f"{sorted(lens.tolist())} ({int(lens.sum())} tok), {toks} new "
        f"tokens in {wall:.3f} s ({toks / wall:.1f} tok/s), ttft p50/p99 "
        f"{s['ttft_p50_s']:.4f}/{s['ttft_p99_s']:.4f} s, itl p50/p99 {s['itl_p50_s'] * 1e3:.2f}/"
        f"{s['itl_p99_s'] * 1e3:.2f} ms, decode steps {s['decode_steps']}, "
        f"prefill chunks {s['prefill_chunks']}, max iter tokens "
        f"{s['max_iter_tokens']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("serve", f"launches: paged_flash_decode {n_dec} = "
        f"{cfg.n_layers()} x {s['decode_steps']} decode steps, "
        f"paged_flash_prefill {n_pre} = "
        f"{cfg.n_layers()} x {s['prefill_chunks']} prompt chunks")


def card_vs_cpu():
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.cache import CacheConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    cfg = configs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32)
    model = transformer.init_model(cfg, torch.Generator().manual_seed(0))
    conf = EngineConfig(n_slots=3, max_seq=64, chunked=True, token_budget=8,
                        cache=CacheConfig(page_tokens=8))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in (6, 13, 3, 9, 30, 1)]
    on_cpu = serve(Engine(cfg, copy.deepcopy(model), config=conf,
                          device="cpu"), prompts, 8)
    on_card = serve(Engine(cfg, model, config=conf, device="cuda"),
                    prompts, 8)
    assert on_card == on_cpu, (on_card, on_cpu)
    log("card/cpu", f"smoke config f32: {len(on_card)} greedy streams equal "
        "on cuda and cpu")


# the kernel templates' mangled names, as ptxas prints them, shortened
KERNEL_NAMES = (
    (r"GemmBodyILi(\d)ELi(\d)E(f|13__nv_bfloat16)Lb(\d)E",
     lambda m: f"gemm {('mxu', 'vpu', 'loop')[int(m[1])]} fpw {m[2]} "
     f"{'f32' if m[3] == 'f' else 'bf16'}{' gram' if m[4] == '1' else ''}"),
    (r"MatvecBodyILb(\d)E(f|13__nv_bfloat16)Lb(\d)E",
     lambda m: f"matvec{'_t' if m[1] == '1' else ''} "
     f"{'f32' if m[2] == 'f' else 'bf16'} "
     f"{'staged' if m[3] == '1' else 'unstaged'}"),
    (r"CenterBodyI(f|13__nv_bfloat16)E",
     lambda m: f"center {'f32' if m[1] == 'f' else 'bf16'}"),
    (r"decode_kernelI(f|13__nv_bfloat16)Li(\d+)E",
     lambda m: f"flash_decode {'f32' if m[1] == 'f' else 'bf16'} hd {m[2]}"),
    (r"conv2d_bandI(f|13__nv_bfloat16)Li(\d+)E",
     lambda m: f"conv2d {'f32' if m[1] == 'f' else 'bf16'} vec {m[2]}"),
    (r"flash_mmaILi(\d+)E", lambda m: f"flash_mma hd {m[1]} (tensor cores)"),
    (r"flash_kernelIfLi(\d+)E",
     lambda m: f"flash_kernel hd {m[1]} (CUDA cores, f32)"))


INSTANCES = {}   # short kernel instance name -> "N registers; spills"


def build_kernels() -> None:
    """Build every kernel library (one nvcc each, in parallel) and log each
    kernel instance's registers and spills from ptxas."""
    import re
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log("build", f"{len(_build.SIGNATURES)} kernel libraries built with "
        f"nvcc for sm_90a in {time.perf_counter() - t0:.2f} s (set-up)")
    for name, out in _build.BUILD_LOG.items():
        fn, spill = "", ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
                for pat, short in KERNEL_NAMES:
                    m = re.search(pat, fn)
                    if m:
                        fn = short(m)
                        break
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used (\d+) registers", line)
                INSTANCES[fn] = f"{regs[1]} registers; {spill}"
                log("build", f"{name}: {fn[-60:]}: {regs[1]} registers; "
                    f"{spill}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.kernel_suite import card_line
    card = card_line()
    log("card", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, tf32 cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    build_kernels()
    results = {
        "paged_flash_decode": {
            "name": "paged_flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:44",
            "launches": 0, "max_abs_err": 0.0},
        "paged_flash_prefill": {
            "name": "paged_flash_prefill", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_prefill_attention.cu",
            "replaces": "src/repro/kernels/paged_prefill_attention.py:46",
            "launches": 0, "max_abs_err": 0.0},
    }
    for name, replaces in (
            ("autodma_tiled", "src/repro/core/autodma.py:321"),
            ("gemm", "src/repro/kernels/gemm.py:62"),
            ("matvec", "src/repro/kernels/polybench.py:31"),
            ("matvec_t", "src/repro/kernels/polybench.py:39"),
            ("covar", "src/repro/kernels/polybench.py:142")):
        results[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/autodma_tiled.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0}
    for name, source, replaces in (
            ("conv2d", "conv2d_3x3.cu", "polybench.py:94"),
            ("flash_decode", "decode_attention.cu", "decode_attention.py:26"),
            ("flash_attention", "flash_attention.cu",
             "flash_attention.py:55")):
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": 0,
            "max_abs_err": 0.0}
    check_kernels(results)
    torch.cuda.synchronize()
    check_suite_kernels(results)
    torch.cuda.synchronize()
    check_attention_kernels(results)
    torch.cuda.synchronize()
    suite_main_path(results)
    torch.cuda.synchronize()
    full_width_serve(results, card)
    card_vs_cpu()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in results.values()]
    assert all(math.isfinite(r["ms"]) for r in kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
