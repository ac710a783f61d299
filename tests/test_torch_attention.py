"""The port's dense flash_attention (with plan_blocks) and flash_decode
against the JAX package.

Inputs are made with numpy from a seed and go through both packages: the
JAX Pallas kernels in interpret mode (as tests/test_kernels.py runs them,
at its shapes and blocks) and their oracles, and the port's wrappers on CPU
tensors, which take the kernels' plain PyTorch versions. Tolerance rtol =
atol = 2e-3, as in the JAX kernel tests; bf16 outputs may differ in
addition by one bf16 rounding step of the value (2^-8 relative), since both
sides round an f32 result to bf16. The ``cuda``-marked test at the end
holds the CUDA kernels against the same plain versions on the card.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as tpda
from repro_torch.kernels import ref as tref

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=2e-3, atol=2e-3)
BF16_TOL = dict(rtol=2**-8, atol=2e-3)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


ATTENTION_CASES = [  # (B, H, L, Lk, hd), causal, window, softcap, dtype
    ((1, 2, 256, 256, 64), True, None, None, "f32"),
    ((1, 2, 256, 256, 64), False, None, None, "f32"),
    ((2, 4, 128, 128, 128), True, None, None, "f32"),
    ((2, 4, 128, 128, 128), False, None, None, "f32"),
    ((1, 2, 256, 256, 64), True, 64, None, "f32"),
    ((1, 2, 256, 256, 64), False, 64, None, "f32"),
    ((2, 4, 128, 128, 32), True, None, 20.0, "f32"),
    ((1, 2, 256, 256, 64), False, 48, 5.0, "f32"),
    ((1, 2, 256, 256, 64), True, None, None, "bf16"),
    ((2, 4, 128, 128, 128), True, 64, 20.0, "bf16"),
    # rows past Lk + window see no key: the mean of V over the run blocks
    ((1, 2, 256, 128, 64), True, 32, None, "f32"),
]


@pytest.mark.parametrize("shape,causal,window,softcap,dtype", ATTENTION_CASES)
def test_flash_attention_matches_jax(shape, causal, window, softcap, dtype):
    B, H, L, Lk, hd = shape
    rng = np.random.default_rng(sum(shape) + (window or 0))
    q = rand(rng, B, H, L, hd)
    k, v = rand(rng, B, H, Lk, hd), rand(rng, B, H, Lk, hd)
    kw = dict(causal=causal, window=window, softcap=softcap, block_q=64,
              block_k=64)
    if dtype == "bf16":
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                      for x in (jq, jk, jv))
        tol = BF16_TOL
    else:
        jq, jk, jv = _j(q, k, v)
        tq, tk, tv = _t(q, k, v)
        tol = TOL
    out = tfa.flash_attention(tq, tk, tv, **kw)
    jout = jfa.flash_attention(jq, jk, jv, **kw)
    assert out.dtype == tq.dtype and tuple(out.shape) == (B, H, L, hd)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), **tol)
    if L == Lk:   # every row sees a key: the oracle agrees as well
        exp = tref.attention(tq, tk, tv, causal=causal, window=window,
                             softcap=softcap)
        np.testing.assert_allclose(out.float().numpy(), exp.float().numpy(),
                                   **tol)
    else:         # rows 159.. see none and average V over all 128 keys
        mean_v = v.mean(axis=2, keepdims=True)
        np.testing.assert_allclose(out.numpy()[:, :, 159:],
                                   np.broadcast_to(mean_v, (B, H, L - 159,
                                                            hd)), **TOL)


def test_attention_oracles_match_jax():
    rng = np.random.default_rng(9)
    q, k, v = (rand(rng, 1, 2, 64, 32) for _ in range(3))
    for causal, window in ((True, None), (False, 16), (True, 8)):
        np.testing.assert_allclose(
            ops.REFS["flash_attention"](*_t(q, k, v), causal=causal,
                                        window=window).numpy(),
            np.asarray(jref.attention(*_j(q, k, v), causal=causal,
                                      window=window)), rtol=1e-5, atol=1e-5)
    out = ops.flash_attention(*_t(q, k, v), window=16, block_q=32,
                              block_k=32)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.attention(*_j(q, k, v), window=16)),
        **TOL)


@pytest.mark.parametrize("budget", [1 << 17, 231_424, 1 << 20, 16 << 20,
                                    96 << 20])
def test_plan_blocks_equals_jax(budget):
    for L in (64, 128, 256, 1000, 2048, 4096):
        for Lk in (128, 512, 2048, 4096):
            for hd in (32, 64, 128):
                for itemsize in (2, 4):
                    assert tfa.plan_blocks(L, Lk, hd, itemsize, budget) == \
                        jfa.plan_blocks(L, Lk, hd, itemsize, budget), (
                            L, Lk, hd, itemsize, budget)


def test_plan_blocks_at_the_h100_budget():
    """At one block's shared memory (231,424 B) the planner fits (128, 128)
    for qwen2-0.5b's bf16 hd 64; for gemma3-27b's hd 128 nothing fits and
    it falls through to its default (128, 128), which the VMEM count puts
    over the budget: the CUDA kernel tiles shared memory for itself."""
    assert tfa.plan_blocks(2048, 2048, 64, 2) == (128, 128)
    assert tfa.plan_blocks(4096, 4096, 128, 2) == (128, 128)
    work = (128 * 128 + 2 * 128 * 128 + 128 * 128) * 2 * 2
    assert work > 231_424


DECODE_SHAPES = [(2, 8, 2, 256, 64), (1, 4, 4, 512, 128), (3, 6, 3, 384, 64)]


def _decode_inputs(rng, B, H, K, S, hd):
    return (rand(rng, B, H, hd), rand(rng, B, K, S, hd),
            rand(rng, B, K, S, hd))


@pytest.mark.parametrize("B,H,K,S,hd", DECODE_SHAPES)
@pytest.mark.parametrize("lengths", ["ragged", "full", "with_zero"])
def test_flash_decode_matches_jax(B, H, K, S, hd, lengths):
    rng = np.random.default_rng(B * 100 + S)
    q, k, v = _decode_inputs(rng, B, H, K, S, hd)
    lens = {"ragged": rng.integers(1, S, B),
            "full": np.full(B, S),
            "with_zero": np.array([0, S, 17][:B] if B > 1 else [0])
            }[lengths].astype(np.int32)
    block_k = 128 if lengths == "ragged" else 64
    out = tda.flash_decode(*_t(q, k, v, lens), block_k=block_k)
    jout = jda.flash_decode(*_j(q, k, v, lens), block_k=block_k)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    exp = jda.decode_attention_ref(*_j(q, k, v, lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)
    np.testing.assert_allclose(
        out.numpy(), tda.decode_attention_ref(*_t(q, k, v, lens)).numpy(),
        **TOL)
    G = H // K
    for b in np.flatnonzero(lens == 0):   # the mean of V over all S
        np.testing.assert_allclose(
            out.numpy()[b], np.repeat(v[b].mean(axis=1), G, axis=0), **TOL)


def test_flash_decode_bf16_matches_jax():
    rng = np.random.default_rng(10)
    B, H, K, S, hd = 3, 14, 2, 256, 64
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16)
                  for x in _decode_inputs(rng, B, H, K, S, hd))
    lens = np.array([0, 200, 256], np.int32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                  for x in (jq, jk, jv))
    out = tda.flash_decode(tq, tk, tv, torch.from_numpy(lens), block_k=64)
    jout = jda.flash_decode(jq, jk, jv, jnp.asarray(lens), block_k=64)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), **BF16_TOL)


def test_block_k_and_splits():
    """The plain version's tile follows the reference's shrink rule; the
    kernel's splits cover S in whole 64-key runs and give the (slot, kv
    head) pairs about two blocks per SM."""
    assert [tda.decode_block_k(S, b) for S, b in
            ((2048, 512), (384, 128), (100, 512), (96, 64), (97, 64))] == \
        [512, 128, 100, 48, 1]
    launch = tda.decode_launch(8, 14, 2, 2048, 64, 132)   # 16 pairs
    assert (launch.nsplit, launch.chunk) == (16, 128)
    launch = tda.decode_launch(1, 1, 1, 64, 64, 132)      # 1 pair
    assert (launch.nsplit, launch.chunk) == (1, 64)
    for B, K in ((1, 1), (2, 1), (7, 1), (8, 2), (150, 2)):
        for S in (1, 63, 64, 100, 2048, 5000):
            launch = tda.decode_launch(B, 2 * K, K, S, 64, 132)
            n, chunk = launch.nsplit, launch.chunk
            assert chunk % 64 == 0 and (n - 1) * chunk < S <= n * chunk


def test_paged_plain_matches_dense_plain():
    """The same logical cache through the port's paged and dense decode
    (as test_paged_matches_dense_flash_decode does for the JAX kernels)."""
    rng = np.random.default_rng(3)
    B, H, K, hd, pt, n_pages = 2, 8, 2, 64, 16, 16
    q = rand(rng, B, H, hd)
    lengths = np.array([37, 61], np.int32)
    kp, vp = rand(rng, n_pages, K, pt, hd), rand(rng, n_pages, K, pt, hd)
    table = np.full((B, 4), -1, np.int32)
    perm = rng.permutation(n_pages)
    table[0, :3], table[1, :4] = perm[:3], perm[3:7]
    tq, tkp, tvp, ttab, tlen = _t(q, kp, vp, table, lengths)
    out_paged = tpda.paged_flash_decode(tq, tkp, tvp, ttab, tlen)
    out_dense = tda.flash_decode(tq, tpda.gather_pages(tkp, ttab),
                                 tpda.gather_pages(tvp, ttab), tlen,
                                 block_k=pt)
    np.testing.assert_allclose(out_paged.numpy(), out_dense.numpy(), **TOL)


def test_cpu_calls_count_no_launch():
    rng = np.random.default_rng(11)
    q, k, v = _t(*(rand(rng, 1, 2, 64, 32) for _ in range(3)))
    dq, dk, dv = _t(*_decode_inputs(rng, 1, 2, 1, 64, 32))
    before = (tfa.flash_attention.launches, tda.flash_decode.launches)
    ops.flash_attention(q, k, v)
    tda.flash_decode(dq, dk, dv, torch.tensor([5], dtype=torch.int32))
    assert (tfa.flash_attention.launches, tda.flash_decode.launches) == \
        before


def test_port_modules_leave_jax_and_repro_out():
    code = ("import sys\n"
            "import repro_torch\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.polybench\n"
            "import repro_torch.kernels.decode_attention\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.launch.kernel_suite\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ISOLATED')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=SRC,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr


def _close(out, plain, tol=2e-3):
    """|kernel - plain| <= tol, plus one bf16 rounding step for bf16."""
    lim = tol + (2**-8 * plain.float().abs() if plain.dtype == torch.bfloat16
                 else 0.0)
    return bool(((out.float() - plain.float()).abs() <= lim).all())


@pytest.mark.cuda
def test_cuda_attention_kernels_match_their_plain_versions():
    """On the card: flash_attention (every option, f32 and bf16, hd 32 /
    64 / 128, rows that see no key) and flash_decode (ragged lengths with
    0 and S, f32 and bf16) against their plain versions on the same
    tensors, each launch counted; an hd the kernels do not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_attention.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, L, Lk, hd), causal, window, softcap, dt in ATTENTION_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q = torch.randn(B, H, L, hd, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(B, H, Lk, hd, generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap, block_q=64,
                  block_k=64)
        n0 = tfa.flash_attention.launches
        out = tfa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == n0 + 1
        assert _close(out, tfa.flash_attention_plain(q, k, v, **kw)), (
            B, H, L, Lk, hd, causal, window, softcap, dt)
    with pytest.raises(ValueError, match="hd 48"):
        tfa.flash_attention(*(torch.zeros(1, 1, 64, 48, device="cuda")
                              for _ in range(3)))
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, K, S, hd in DECODE_SHAPES + [(8, 14, 2, 2048, 64)]:
            q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
            kc, vc = (torch.randn(B, K, S, hd, generator=g, device="cuda")
                      .to(dtype) for _ in range(2))
            lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda",
                                 dtype=torch.int32)
            lens[0] = 0
            lens[-1] = S
            n0 = tda.flash_decode.launches
            out = tda.flash_decode(q, kc, vc, lens)
            torch.cuda.synchronize()
            assert tda.flash_decode.launches == n0 + 1
            assert _close(out, tda.flash_decode_plain(q, kc, vc, lens)), (
                B, H, K, S, hd, dtype)
