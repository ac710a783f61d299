"""The port's kernel suite (gemm with its three bodies, matvec, matvec_t,
2mm, 3mm, atax, bicg) against the JAX package.

Inputs are made with numpy from a seed and go through both packages: the
JAX Pallas kernels in interpret mode (as tests/test_kernels.py runs them,
at its sizes, its 512 KiB budget and its tolerances) and the port's
functions on CPU tensors, which take the plain grid walker with the
bodies' plain PyTorch forms. The ``cuda``-marked test at the end holds the
CUDA builder against that walker on the card.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm as jgemm
from repro.kernels import polybench as jpb
from repro.kernels import ref as jref
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops
from repro_torch.kernels import polybench as tpb
from repro_torch.kernels import tiled

BUDGET = 512 * 1024  # the JAX tests' budget: multi-block grids at test sizes
TOL = dict(rtol=2e-4, atol=2e-4)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (256, 384, 512),
                                   (8, 128, 256), (136, 128, 128)])
@pytest.mark.parametrize("mode", ["autodma", "paper", "unmodified"])
def test_gemm_modes_match_jax(M, N, K, mode):
    rng = np.random.default_rng(M + N + K)
    A, B = rand(rng, M, K), rand(rng, K, N)
    out, plan = tgemm.gemm(*_t(A, B), mode=mode, budget=BUDGET)
    jout, jplan = jgemm.gemm(A, B, mode=mode, budget=BUDGET)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(out.numpy(), jref.gemm(A, B), **TOL)
    assert plan.vmem_bytes <= BUDGET or mode == "unmodified"


@pytest.mark.parametrize("body", ["mxu", "vpu", "loop"])
@pytest.mark.parametrize("alpha", [1.0, -0.75])
def test_gemm_bodies_match_jax(body, alpha):
    rng = np.random.default_rng(11)
    A, B = rand(rng, 128, 256), rand(rng, 256, 128)
    out, _ = tgemm.gemm(*_t(A, B), alpha=alpha, body=body, budget=BUDGET)
    jout, _ = jgemm.gemm(A, B, alpha=alpha, body=body, budget=BUDGET)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_gemm_bf16_matches_jax():
    rng = np.random.default_rng(12)
    A = jnp.asarray(rand(rng, 128, 256), jnp.bfloat16)
    B = jnp.asarray(rand(rng, 256, 128), jnp.bfloat16)
    tA = torch.from_numpy(np.asarray(A, np.float32)).bfloat16()
    tB = torch.from_numpy(np.asarray(B, np.float32)).bfloat16()
    out, plan = tgemm.gemm(tA, tB, budget=BUDGET)
    assert out.dtype == torch.bfloat16 and plan.spec.arrays[0].itemsize == 2
    jout, _ = jgemm.gemm(A, B, budget=BUDGET)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=1e-1,
                               atol=1e-1)


@pytest.mark.parametrize("tiles", [(128, 128, 256), (64, 128, 64)])
def test_gemm_handwritten_matches_jax(tiles):
    rng = np.random.default_rng(13)
    A, B = rand(rng, 256, 256), rand(rng, 256, 256)
    out, plan = tgemm.gemm(*_t(A, B), handwritten_tiles=tiles)
    jout, jplan = jgemm.gemm(A, B, handwritten_tiles=tiles)
    assert plan.mode == jplan.mode == "handwritten" and plan.tiles == tiles
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("body", ["mxu", "vpu", "loop"])
def test_gemm_tile_that_does_not_divide(body):
    """Handwritten tiles (48, 80, 96) over 200 x 300 x 170: every axis ends
    in a short block. The JAX Pallas kernel reads undefined padding there,
    so the port is held against the oracle."""
    rng = np.random.default_rng(14)
    A, B = rand(rng, 200, 170), rand(rng, 170, 300)
    out, plan = tgemm.gemm(*_t(A, B), alpha=0.5, body=body,
                           handwritten_tiles=(48, 80, 96))
    assert plan.grid == (5, 4, 2)
    np.testing.assert_allclose(out.numpy(), jref.gemm(A, B, alpha=0.5),
                               **TOL)


def test_2mm_3mm_match_jax():
    rng = np.random.default_rng(15)
    A, B, C, D = (rand(rng, 64, 128), rand(rng, 128, 256),
                  rand(rng, 256, 128), rand(rng, 128, 64))
    out, _ = tpb.mm2(*_t(A, B, C), budget=BUDGET)
    jout, _ = jpb.mm2(A, B, C, budget=BUDGET)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(out.numpy(), jref.mm2(A, B, C), rtol=2e-3,
                               atol=2e-3)
    out3, _ = tpb.mm3(*_t(A, B, C, D), budget=BUDGET)
    jout3, _ = jpb.mm3(A, B, C, D, budget=BUDGET)
    np.testing.assert_allclose(out3.numpy(), np.asarray(jout3), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(out3.numpy(), jref.mm3(A, B, C, D),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("M,N", [(256, 256), (512, 384)])
@pytest.mark.parametrize("mode", ["autodma", "paper", "unmodified"])
def test_atax_bicg_match_jax(M, N, mode):
    rng = np.random.default_rng(M + N)
    A, x, p, r = rand(rng, M, N), rand(rng, N), rand(rng, N), rand(rng, M)
    y, _ = tpb.atax(*_t(A, x), mode=mode, budget=BUDGET)
    jy, _ = jpb.atax(A, x, mode=mode, budget=BUDGET)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-3,
                               atol=2e-3)
    (q, s), plans = tpb.bicg(*_t(A, p, r), mode=mode, budget=BUDGET)
    (jq, js), jplans = jpb.bicg(A, p, r, mode=mode, budget=BUDGET)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-3,
                               atol=2e-3)
    for tp, jp in zip(plans, jplans):   # matvec_t reads A through (1, 0)
        assert [a.dims for a in tp.spec.arrays] == \
            [a.dims for a in jp.spec.arrays]


def test_ops_surface_matches_its_oracles():
    rng = np.random.default_rng(16)
    A, B, C, D = (rand(rng, 96, 64), rand(rng, 64, 160), rand(rng, 160, 64),
                  rand(rng, 64, 32))
    x, r = rand(rng, 64), rand(rng, 96)
    tA, tB, tC, tD, tx, tr = _t(A, B, C, D, x, r)
    for mode in ("autodma", "paper", "unmodified"):
        np.testing.assert_allclose(ops.gemm(tA, tB, mode=mode).numpy(),
                                   ops.REFS["gemm"](tA, tB).numpy(), **TOL)
        np.testing.assert_allclose(ops.mm2(tA, tB, tC, mode=mode).numpy(),
                                   ops.REFS["mm2"](tA, tB, tC).numpy(),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(
            ops.mm3(tA, tB, tC, tD, mode=mode).numpy(),
            ops.REFS["mm3"](tA, tB, tC, tD).numpy(), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(ops.atax(tA, tx, mode=mode).numpy(),
                                   ops.REFS["atax"](tA, tx).numpy(),
                                   rtol=2e-3, atol=2e-3)
        for got, exp in zip(ops.bicg(tA, tx, tr, mode=mode),
                            ops.REFS["bicg"](tA, tx, tr)):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=2e-3,
                                       atol=2e-3)
    # the port's oracles are the JAX ones
    np.testing.assert_allclose(ops.REFS["atax"](tA, tx).numpy(),
                               np.asarray(jref.atax(A, x)), rtol=1e-4,
                               atol=1e-4)
    hw = ops.mm3(tA, tB, tC, tD, handwritten_tiles=(32, 32, 32))
    np.testing.assert_allclose(hw.numpy(), jref.mm3(A, B, C, D), rtol=2e-2,
                               atol=2e-2)


def test_cpu_calls_count_no_launch():
    rng = np.random.default_rng(17)
    tA, tx = _t(rand(rng, 64, 64), rand(rng, 64))
    before = (tiled.launch.launches, tgemm.gemm.launches,
              tpb.matvec.launches, tpb.matvec_t.launches)
    ops.gemm(tA, tA)
    ops.atax(tA, tx)
    assert (tiled.launch.launches, tgemm.gemm.launches, tpb.matvec.launches,
            tpb.matvec_t.launches) == before


def test_kernel_suite_runs_on_the_cpu_when_asked(tmp_path):
    """python -m repro_torch.launch.kernel_suite --device cpu: every Fig. 7
    row (handwritten for the gemm family), the tile sweep and the ISA rows,
    at sizes / 32, with host-clock times labelled as such."""
    from repro_torch.launch import kernel_suite
    out = tmp_path / "k.json"
    assert kernel_suite.main(["--device", "cpu", "--iters", "1", "--scale",
                              "32", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"].startswith("cpu") and res["time_unit"] == "host ms"
    modes = {}
    for r in res["fig7"]:
        modes.setdefault(r["kernel"], []).append(r["mode"])
    assert modes == {k: ["unmodified", "paper", "autodma"] + (
        ["handwritten"] if k in kernel_suite.GEMM_FAMILY else [])
        for k in ("gemm", "2mm", "3mm", "atax", "bicg", "darknet")}
    assert len(res["sweep"]) == 2 * len(kernel_suite.SWEEP_TILES)
    assert [r["kernel"] for r in res["isa"]] == list(kernel_suite.ISA_SIZES)
    assert res["summary"]["paper_claims"]["max_speedup_vs_unmodified"] == 4.4


def test_kernel_suite_needs_a_card_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid here")
    from repro_torch.launch import kernel_suite
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_suite.main(["--out", str(tmp_path / "k.json")])


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_cuda_builder_matches_the_plain_walker():
    """On the card: every body and mode, f32 and bf16, a ragged shape and
    a ragged handwritten tile, each launch counted; a plan over the
    shared-memory limit raises. Tolerances (relative
    Frobenius error against the walker on the same CUDA tensors): mxu f32
    5e-3 (TF32 keeps a 10-bit mantissa), vpu / loop / matvec f32 1e-5
    (f32 sums in another order), bf16 1e-2 (the output is rounded to bf16
    after every reduction step on both sides)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_suite.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for M, N, K, hw in [(512, 384, 640, (128, 128, 64)),
                        (200, 300, 170, (48, 80, 96))]:
        for dt in (torch.float32, torch.bfloat16):
            A = torch.randn(M, K, generator=g, device="cuda").to(dt)
            B = torch.randn(K, N, generator=g, device="cuda").to(dt)
            for body in ("mxu", "vpu", "loop"):
                tol = 1e-2 if dt == torch.bfloat16 else (
                    5e-3 if body == "mxu" else 1e-5)
                # no tile divides 200 x 300 x 170, so paper's rule falls
                # back to whole axes, over the shared-memory limit in f32
                over = M == 200 and dt == torch.float32
                modes = ("autodma", "unmodified", None) if over else (
                    "autodma", "paper", "unmodified", None)
                for mode in modes:
                    kw = dict(mode=mode) if mode else dict(
                        handwritten_tiles=hw)
                    n0 = (tiled.launch.launches, tgemm.gemm.launches)
                    out, plan = tgemm.gemm(A, B, alpha=0.5, body=body, **kw)
                    torch.cuda.synchronize()
                    assert (tiled.launch.launches, tgemm.gemm.launches) == (
                        n0[0] + 1, n0[1] + 1)
                    plain, _ = tgemm.gemm(A.cpu(), B.cpu(), alpha=0.5,
                                          body=body, plan=plan)
                    assert _rel(out.cpu(), plain) <= tol, (M, dt, body, mode)
            if M == 200 and dt == torch.float32:
                with pytest.raises(ValueError, match="may use 232448"):
                    tgemm.gemm(A, B, mode="paper")
            x = torch.randn(K, generator=g, device="cuda").to(dt)
            xt = torch.randn(M, generator=g, device="cuda").to(dt)
            for mode in ("autodma", "paper", "unmodified"):
                for fn, v in ((tpb.matvec, x), (tpb.matvec_t, xt)):
                    n0 = fn.launches
                    y, _ = fn(A, v, mode=mode)
                    torch.cuda.synchronize()
                    assert fn.launches == n0 + 1
                    plain, _ = fn(A.cpu(), v.cpu(), mode=mode)
                    tol = 1e-2 if dt == torch.bfloat16 else 1e-5
                    assert _rel(y.cpu(), plain) <= tol, (fn, M, dt, mode)
