"""The register-blocked gemm layout of the port's AutoDMA builder on the
H100, checked on the CPU over every plan the kernel suite makes.

csrc/autodma_tiled.cu runs every gemm body (mxu, vpu, loop, and covar's
gram) with one warp layout: each warp owns a sub-tile of ``fpw`` fragments
of 16 rows by one of 32 columns, ``kernels/tiled.py`` picks ``fpw``, the
warp count and the passes from the plan's output tile. For each plan below
(Fig. 7 at N = 2048 in every mode, darknet, the ISA sizes, covar's gram,
the handwritten and sweep tiles, and hypothesis-drawn ragged plans) the
layout is checked: threads within the gemm kernel's launch bound, shared
memory within 232,448 B and never above the plan's own
bytes, and the warps' sub-tiles, over all passes, covering each fragment of
the output tile exactly once. The mxu body's TF32 rounding (``cvt.rna``,
once per element loaded) is emulated in plain PyTorch, per plan reduction
step with alpha and the rounding to the dtype applied once per step, and
held against the plain grid walker within the 5e-3 relative Frobenius error
that chip_smoke.py and tests/test_torch_suite.py hold the card to. The
``cuda``-marked test at the end runs the builder on the card.
"""
import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import autodma as tad
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import polybench as tpb
from repro_torch.kernels import tiled
from repro_torch.launch.kernel_suite import (DARKNET, HANDWRITTEN_TILES,
                                             ISA_SIZES, N, SWEEP_TILES)

SMEM_PER_BLOCK = 232_448
MXU_F32_TOL = 5e-3
MODES = ("unmodified", "paper", "autodma")
BODIES = ("gemm_mxu", "gemm_vpu", "gemm_loop")


def _spec(spec, dtype):
    return tad.KernelSpec(spec.name, spec.loop_bounds, tuple(
        tad.ArrayAccess(a.name, a.shape, a.dims, dtype, a.is_output)
        for a in spec.arrays), spec.reduction_axes, spec.flops_per_point)


def suite_plans():
    """(label, body, plan) for every gemm-family plan the suite launches."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        shapes = [(N, N, N), DARKNET] + list(ISA_SIZES.values())
        for M, Nn, K in shapes:
            spec = tad.matmul_spec(M, Nn, K, dtype=dtype)
            plans = [tad.plan(spec, mode=m) for m in MODES]
            plans.append(tgemm._plan_with_tiles(spec, HANDWRITTEN_TILES))
            if (M, Nn, K) == (N, N, N):
                plans += [tgemm._plan_with_tiles(spec, t)
                          for t in SWEEP_TILES]
            for p in plans:
                for body in BODIES:
                    out.append((f"{spec.name} {M}x{Nn}x{K} {dtype}", body, p))
        for M, Nn in ((N, N), (1000, 600)):
            spec = tpb.gram_spec(M, Nn, dtype)
            for m in ("unmodified", "autodma") + (("paper",) if M == N
                                                  else ()):
                out.append((f"gram {M}x{Nn} {dtype}", "gram",
                            tad.plan(spec, mode=m)))
    ragged = tad.matmul_spec(1000, 600, 1100)
    for p in (tad.plan(ragged, mode="unmodified"),
              tad.plan(ragged, mode="autodma"),
              tgemm._plan_with_tiles(ragged, (48, 80, 96))):
        for body in BODIES:
            out.append(("gemm ragged", body, p))
    return out


def sub_tiles(f):
    """The kernel's GemmBody::origin over all passes and warps: (r0 in
    fragments, c0 in fragments, fragments) of each sub-tile, before the
    ragged-edge cut (which only drops fragments outside the tile)."""
    wr, nrg, ncg = f["fpw"], f["nrg"], f["ncg"]
    warps = f["threads"] // 32
    nwr = -(-nrg // wr)
    tiles = []
    for p in range(f["npass"]):
        for w in range(warps):
            wt = p * warps + w
            if wt >= nwr * ncg:
                continue
            wrow, wcol = divmod(wt, ncg)
            nrf = min(wr, nrg - wrow * wr)
            tiles.append((wrow * wr, wcol, nrf))
    return tiles


def padded_bytes(f):
    """A plan's staged input blocks once zero-padded to whole fragments (16
    rows, 32 columns) at their skewed row pitch (at most 8 words past the
    padded row): what a ragged block needs beyond the plan's own count."""
    item = 4 if f["dtype"] == tiled.DTYPES[torch.float32] else 2
    per_buf = 0
    for k in range(2):
        prow, pcol, ld = (f[f"in{k}_{x}"] for x in ("prow", "pcol", "ld"))
        assert prow % 16 == 0 and pcol % 32 == 0
        assert 0 < (ld - pcol) * item <= 32
        per_buf += -(-prow * ld * item // 16) * 16
    return per_buf * f["nbuf"]


def check_layout(label, body, p, strict=True):
    """The layout rules; ``strict``: shared memory within the plan's own
    bytes (the suite's plans), else within them or, for a block cut
    ragged, its padding to whole fragments."""
    f = tiled.layout(body, p)
    # the kernel's launch bound: 256 threads, so 255 registers a thread
    assert f["threads"] <= 32 * tiled.MAX_GEMM_WARPS and f["threads"] % 32 == 0
    assert f["smem"] <= SMEM_PER_BLOCK, (label, p.tiles)
    if f["staged"]:
        limit = p.vmem_bytes if strict else max(p.vmem_bytes,
                                                padded_bytes(f))
        assert f["smem"] <= limit, (label, p.tiles, f["smem"])
    cover = np.zeros((f["nrg"], f["ncg"]), int)
    for r0, c0, nrf in sub_tiles(f):
        cover[r0:r0 + nrf, c0] += 1
    assert (cover == 1).all(), (label, p.tiles, f["fpw"], f["npass"])
    # the passes are as few as the sub-tile allows
    warps = f["threads"] // 32
    assert (f["npass"] - 1) * warps < len(sub_tiles(f)) or f["npass"] == 1
    return f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_suite_plans_layout(dtype):
    seen = set()
    for label, body, p in suite_plans():
        if dtype not in label:
            continue
        f = check_layout(label, body, p)
        seen.add((f["fpw"], f["npass"] > 1))
    assert {(1, False), (2, False), (4, False), (4, True)} <= seen, seen


def test_layouts_at_the_main_plans():
    """gemm 2048³ f32: autodma's (64, 64, 128) tile as 8 warps of 16 x 32;
    paper's (128, 128, 128) as 8 warps of 64 x 32; handwritten (64, 128,
    128) as 8 warps of 32 x 32; every unmodified tile (64 x 64) as autodma's.
    The skews: A's rows 16 bytes apart mod 128 (ldmatrix), f32 B rows 8
    words (scalar (k = q, n = g) reads in 32 banks), bf16 B 16 bytes
    (ldmatrix.trans)."""
    spec = tad.matmul_spec(N, N, N)
    want = {"autodma": (1, 256, 1), "paper": (4, 256, 1),
            "unmodified": (1, 256, 1)}
    for mode, exp in want.items():
        f = tiled.layout("gemm_mxu", tad.plan(spec, mode=mode))
        assert (f["fpw"], f["threads"], f["npass"]) == exp, mode
    f = tiled.layout("gemm_mxu", tgemm._plan_with_tiles(spec,
                                                        HANDWRITTEN_TILES))
    assert (f["fpw"], f["threads"], f["npass"]) == (2, 256, 1)
    assert f["in0_ld"] * 4 % 128 == 16 and f["in1_ld"] % 32 == 8
    fb = tiled.layout("gemm_mxu", tgemm._plan_with_tiles(
        tad.matmul_spec(N, N, N, dtype=torch.bfloat16), HANDWRITTEN_TILES))
    assert fb["in0_ld"] * 2 % 128 == 16 and fb["in1_ld"] * 2 % 128 == 16
    g = tiled.layout("gram", tad.plan(tpb.gram_spec(N, N), mode="autodma"))
    assert g["in0_ld"] % 32 == 8 and g["fpw"] == 1
    gb = tiled.layout("gram", tad.plan(tpb.gram_spec(N, N, torch.bfloat16),
                                       mode="autodma"))
    assert gb["in0_ld"] * 2 % 128 == 16
    # the three ISA bodies share the layout at every plan
    for p in (tad.plan(spec), tad.plan(tad.matmul_spec(*DARKNET))):
        lay = [tiled.layout(b, p) for b in BODIES]
        assert all({k: v for k, v in x.items() if k != "body"} ==
                   {k: v for k, v in lay[0].items() if k != "body"}
                   for x in lay)


@settings(max_examples=60, deadline=None)
@given(M=st.integers(1, 700), Nn=st.integers(1, 700), K=st.integers(1, 700),
       tm=st.sampled_from([16, 32, 48, 64, 96, 128, 192, 256]),
       tn=st.sampled_from([32, 64, 80, 96, 128, 192, 256]),
       tk=st.sampled_from([16, 32, 64, 96, 128]),
       bf16=st.booleans())
def test_ragged_plans_layout(M, Nn, K, tm, tn, tk, bf16):
    """Handwritten tiles over ragged shapes, and the planner's own plans:
    where shared memory holds the blocks, the layout obeys every rule (a
    block cut ragged may take its padding to whole fragments beyond the
    plan's count)."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    spec = tad.matmul_spec(M, Nn, K, dtype=dtype)
    plans = [tgemm._plan_with_tiles(spec, (tm, tn, tk)),
             tad.plan(spec, mode="autodma"), tad.plan(spec, mode="unmodified")]
    for p in plans:
        try:
            check_layout("ragged", "gemm_mxu", p, strict=False)
        except ValueError as e:       # blocks past shared memory: refused
            assert "may use 232448" in str(e)
    try:
        check_layout("ragged gram", "gram",
                     tad.plan(tpb.gram_spec(M, Nn, dtype), mode="autodma"),
                     strict=False)
    except ValueError as e:
        assert "may use 232448" in str(e)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to a 10-bit mantissa, to nearest, ties away
    from zero (add half of the dropped 13 bits to the magnitude, cut)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def builder_mxu(A, B, plan, alpha=1.0):
    """The mxu body's arithmetic over a plan, in plain PyTorch: each block's
    output tile, per plan reduction step, p = TF32(A_blk) @ TF32(B_blk)
    summed in f32 over k-steps of 8, then c = round(c + alpha * p) to the
    dtype (f32 here: no rounding)."""
    M, K = A.shape
    Nn = B.shape[1]
    tm, tn, tk = plan.tiles
    if plan.mode == "unmodified":     # the kernel's own grid, one k-step
        tm, tn, tk = min(M, 64), min(Nn, 64), K
    At, Bt = tf32_rna(A), tf32_rna(B)
    C = torch.zeros(M, Nn)
    for i0 in range(0, M, tm):
        for j0 in range(0, Nn, tn):
            c = torch.zeros(min(tm, M - i0), min(tn, Nn - j0))
            for k0 in range(0, K, tk):
                p = torch.zeros_like(c)
                for kk in range(k0, min(K, k0 + tk), 8):
                    ke = min(K, k0 + tk, kk + 8)
                    p += At[i0:i0 + tm, kk:ke] @ Bt[kk:ke, j0:j0 + tn]
                c = c + alpha * p
            C[i0:i0 + tm, j0:j0 + tn] = c
    return C


@pytest.mark.parametrize("shape,tiles", [
    ((256, 192, 320), None), ((200, 300, 170), (48, 80, 96)),
    ((128, 128, 512), (64, 64, 128)), ((96, 64, 1000), None)])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_tf32_rounding_holds_the_walker(shape, tiles, alpha):
    """TF32 operands rounded once (cvt.rna), f32 sums, alpha and the
    dtype's rounding once per plan step: within 5e-3 relative Frobenius
    error of the plain walker's f32 product, in every mode. Truncating to
    TF32 instead stays within it too, but rounds ~2x farther."""
    M, Nn, K = shape
    rng = np.random.default_rng(sum(shape))
    A = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((K, Nn)).astype(np.float32))
    spec = tad.matmul_spec(M, Nn, K)
    plans = [tad.plan(spec, mode=m) for m in ("autodma", "unmodified")]
    if tiles:
        plans.append(tgemm._plan_with_tiles(spec, tiles))
    for p in plans:
        walker, _ = tgemm.gemm(A, B, alpha=alpha, plan=p)
        got = builder_mxu(A, B, p, alpha)
        err = ((got - walker).norm() / walker.norm()).item()
        assert err <= MXU_F32_TOL, (p.mode, err)
        assert err > 1e-6           # TF32 is not f32: the check can fail
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    e_rna = (tf32_rna(x) - x).abs()
    e_trunc = ((x.view(torch.int32) & ~0x1FFF).view(torch.float32)
               - x).abs()
    assert (e_rna <= 2.0**-11 * x.abs()).all()
    assert e_rna.mean() < 0.6 * e_trunc.mean()


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-10                    # representable in TF32
    half = 2.0**-11                         # half a TF32 step at 1.0
    x = torch.tensor([1.0 + half, -(1.0 + half), 1.0 + half * 0.99, one])
    assert tf32_rna(x).tolist() == [one, -one, 1.0, one]


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_cuda_register_blocked_bodies_match_the_walker():
    """On the card: the three gemm bodies at tiles that give each sub-tile
    height (fpw 1, 2, 4) and passes, f32 and bf16, every mode, a ragged
    shape, and covar's gram, against the plain walker on the same tensors
    (mxu f32 and covar 5e-3, vpu / loop f32 1e-5, bf16 1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_gemm_mma.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    tile_cases = [(16, 32, 32), (64, 64, 64), (128, 128, 32), (64, 128, 64),
                  (256, 256, 16), (48, 80, 96), (96, 96, 96)]
    seen = set()
    for (M, Nn, K), dt in itertools.product(
            [(384, 320, 288), (200, 300, 170)],
            (torch.float32, torch.bfloat16)):
        A = torch.randn(M, K, generator=g, device="cuda").to(dt)
        B = torch.randn(K, Nn, generator=g, device="cuda").to(dt)
        for body in ("mxu", "vpu", "loop"):
            tol = 1e-2 if dt == torch.bfloat16 else (
                MXU_F32_TOL if body == "mxu" else 1e-5)
            kws = [dict(mode="autodma"), dict(mode="unmodified")] + [
                dict(handwritten_tiles=t) for t in tile_cases]
            for kw in kws:
                out, plan = tgemm.gemm(A, B, alpha=0.5, body=body, **kw)
                torch.cuda.synchronize()
                seen.add(tiled.layout(f"gemm_{body}", plan)["fpw"])
                plain, _ = tgemm.gemm(A.cpu(), B.cpu(), alpha=0.5,
                                      body=body, plan=plan)
                assert _rel(out.cpu(), plain) <= tol, (M, dt, body, kw)
    assert seen == {1, 2, 4}
    for (M, Nn), mode in itertools.product([(512, 384), (1000, 600)],
                                           ("autodma", "unmodified")):
        D = torch.randn(M, Nn, generator=g, device="cuda")
        out, (p1, p2) = tpb.covar(D, mode=mode)
        torch.cuda.synchronize()
        assert _rel(out, tpb.covar_plain(D, p1, p2)) <= MXU_F32_TOL
