"""The arithmetic of the port's tensor-core flash_attention kernel on the
H100, held against the JAX reference kernel on the CPU.

The CUDA kernel cannot run here, so its arithmetic for bf16 inputs is
written out below in plain PyTorch, step for step as the ``flash_mma``
kernel of csrc/flash_attention.cu does it: blocks of 4 warps of 16 rows;
64-key tiles of bf16 K and V from the block's key range (cut to the
window and the causal frontier when every row of the block sees a key,
zero-filled past its end); S = Q Kᵀ from bf16 values with f32 sums; scale, softcap, the
mask (keys past a row's run limit excluded, masked logits NEG = -1e30 and
their probabilities not zeroed); the online softmax in f32; P fed to P·V as
a hi + lo pair of bf16 values; a warp skipping the tiles wholly outside its
own rows' range.

Inputs are made with numpy from a seed and rounded to bf16 values; both
sides compute in f32 from them (the JAX Pallas kernel in interpret mode, at
the blocks of tests/test_kernels.py), so the comparison is of the algorithm
and the tolerance is rtol = atol = 2e-3, as in tests/test_torch_attention.py.
The launch helper takes host ints only. The ``cuda``-marked test at the end
holds the kernel against its plain version on the card, also from a CUDA
graph.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa

TOL = dict(rtol=2e-3, atol=2e-3)
NEG = -1e30
KEY_TILE = 64
SMEM_PER_BLOCK = 232_448


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 values, kept as f32."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _hi_lo(x: torch.Tensor):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


class Mask:
    """The kernel's ``Mask`` struct: the reference's mask and blocks."""

    def __init__(self, L, Lk, causal, window, block_q, block_k):
        self.L, self.Lk, self.causal = L, Lk, causal
        self.window = window
        self.bq, self.bk = block_q, block_k

    def run_limit(self, qpos):
        if not self.causal:
            return self.Lk
        qend = (qpos // self.bq) * self.bq + self.bq - 1
        return min(self.Lk, (qend // self.bk + 1) * self.bk)

    def visible(self, qpos, kpos):
        keep = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool)
        if self.causal:
            keep &= kpos[None] <= qpos[:, None]
        if self.window is not None:
            keep &= kpos[None] > qpos[:, None] - self.window
        return keep

    def sees_a_key(self, qpos):
        lo = max(0, qpos - self.window + 1) if self.window is not None else 0
        hi = min(qpos, self.Lk - 1) if self.causal else self.Lk - 1
        return lo <= hi

    def key_range(self, q0, last, trim):
        begin, end = 0, self.run_limit(last)
        if trim:
            if self.window is not None:
                begin = max(0, q0 - self.window + 1) // KEY_TILE * KEY_TILE
            if self.causal:
                end = min(self.Lk, last + 1)
        return begin, end


def flash_mma(q, k, v, causal=True, window=None, softcap=None, block_q=64,
              block_k=64, split_p=True, cut=True):
    """csrc/flash_attention.cu's flash_mma in plain PyTorch: q [B, H, L, hd],
    k / v [B, H, Lk, hd] holding bf16 values (f32 tensors). P is fed as
    bf16 hi + lo, or, with ``split_p=False``, as one bf16 value; with
    ``cut=False`` every tile walks every key below its run limit. Returns
    the f32 output before its rounding to bf16."""
    B, H, L, hd = q.shape
    Lk = k.shape[2]
    if window is not None:     # the wrapper's clamp
        window = min(max(int(window), -Lk), L + 1)
    mk = Mask(L, Lk, causal, window, block_q, block_k)
    scale = 1.0 / math.sqrt(hd)
    qr, kr, vr = (t.reshape(B * H, -1, hd).float() for t in (q, k, v))
    out = torch.zeros(B * H, L, hd)
    rows, wrows = 64, 16               # 4 warps of 16 rows
    for q0 in range(0, L, rows):
        last = min(q0 + rows, L) - 1
        trim = cut and mk.sees_a_key(q0) and mk.sees_a_key(last)
        k_begin, k_end = mk.key_range(q0, last, trim)
        for wq0 in range(q0, last + 1, wrows):       # warps with rows
            wlast = min(wq0 + wrows - 1, last)
            w_begin, w_end = (mk.key_range(wq0, wlast, True) if trim
                              else (k_begin, k_end))
            qpos = torch.arange(wq0, wq0 + wrows)
            lim = torch.tensor([mk.run_limit(int(p)) for p in qpos])
            qw = torch.zeros(B * H, wrows, hd)
            qw[:, :wlast - wq0 + 1] = qr[:, wq0:wlast + 1]
            m = torch.full((B * H, wrows), -math.inf)
            l = torch.zeros(B * H, wrows)
            acc = torch.zeros(B * H, wrows, hd)
            for k0 in range(k_begin, k_end, KEY_TILE):
                if not (k0 < w_end and k0 + KEY_TILE > w_begin):
                    continue
                kt = torch.zeros(B * H, KEY_TILE, hd)
                vt = torch.zeros(B * H, KEY_TILE, hd)
                n = min(KEY_TILE, k_end - k0)      # zeros past the range
                kt[:, :n], vt[:, :n] = kr[:, k0:k0 + n], vr[:, k0:k0 + n]
                kpos = k0 + torch.arange(KEY_TILE)
                s = (qw @ kt.transpose(1, 2)) * scale
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                s = torch.where(mk.visible(qpos, kpos), s, NEG)
                s = torch.where(kpos[None] >= lim[:, None], -math.inf, s)
                m_new = torch.maximum(m, s.amax(-1))
                mu = torch.where(m_new == -math.inf, 0.0, m_new)
                corr = torch.exp(m - mu)
                p = torch.exp(s - mu[..., None])
                l = l * corr + p.sum(-1)
                ph, plo = _hi_lo(p) if split_p else (p.bfloat16().float(),
                                                     torch.zeros_like(p))
                acc = acc * corr[..., None] + ph @ vt + plo @ vt
                m = m_new
            o = acc / l.clamp_min(1e-30)[..., None]
            out[:, wq0:wlast + 1] = o[:, :wlast - wq0 + 1]
    return out.reshape(B, H, L, hd)


def _inputs(seed, B, H, L, Lk, hd):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.standard_normal((B, H, L, hd)).astype(np.float32)),
            _bf16(rng.standard_normal((B, H, Lk, hd)).astype(np.float32)),
            _bf16(rng.standard_normal((B, H, Lk, hd)).astype(np.float32)))


def _jax(q, k, v, **kw):
    return np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), block_q=64,
                                          block_k=64, **kw))


CASES = [  # (B, H, L, Lk, hd), causal, window, softcap
    ((1, 2, 256, 256, 64), True, None, None),
    ((1, 2, 256, 256, 64), False, None, None),
    ((2, 2, 128, 128, 128), True, None, None),
    ((1, 2, 256, 256, 32), True, None, None),
    ((1, 2, 256, 256, 64), True, 64, None),
    ((1, 2, 256, 256, 128), True, 96, 20.0),
    ((1, 2, 256, 256, 64), False, 48, 5.0),
    ((2, 2, 128, 128, 32), True, None, 20.0),
    # rows past Lk + window see no key: the mean of V over the run blocks
    ((1, 2, 256, 128, 64), True, 32, None),
    # ragged L and Lk: against the plain version only (the JAX kernel reads
    # whatever pads its short last key block)
    ((1, 2, 200, 130, 64), False, None, None),
]


@pytest.mark.parametrize("shape,causal,window,softcap", CASES)
def test_flash_mma_matches_jax(shape, causal, window, softcap):
    B, H, L, Lk, hd = shape
    q, k, v = _inputs(sum(shape) + (window or 0), B, H, L, Lk, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_mma(*map(torch.from_numpy, (q, k, v)), **kw)
    if Lk % 64 == 0:   # the reference reads a short last block past Lk
        np.testing.assert_allclose(got.numpy(), _jax(q, k, v, **kw), **TOL)
    plain = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                      block_q=64, block_k=64, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    if Lk < L and causal:   # rows 159.. see none: the mean of V
        np.testing.assert_allclose(
            got.numpy()[:, :, 159:],
            np.broadcast_to(v.mean(axis=2, keepdims=True),
                            (B, H, L - 159, hd)), **TOL)


def test_trimmed_key_range_is_exact():
    """Cutting the key range (block and warp) changes nothing: keys it
    skips get probability exp(NEG - m) = 0 or are wiped by exp(NEG - m) = 0,
    so the kernel's arithmetic with the cut equals the same arithmetic
    walking every key below the run limit, to f32 rounding."""
    q, k, v = map(torch.from_numpy, _inputs(3, 1, 2, 256, 256, 64))
    for causal, window in ((True, 40), (True, None), (False, 100)):
        cut = flash_mma(q, k, v, causal=causal, window=window)
        full = flash_mma(q, k, v, causal=causal, window=window, cut=False)
        np.testing.assert_allclose(cut.numpy(), full.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_no_key_rows_average_v_over_their_run_blocks():
    """L 256, Lk 128, causal, window 32: row qpos sees no key once
    qpos - 31 > 127. Such rows take probability 1 for every key below their
    run limit (NEG - NEG = 0; not zeroed) and 0 past it, so they return the
    mean of V over min(Lk, run limit) keys: 128 here for every row."""
    q, k, v = map(torch.from_numpy, _inputs(5, 1, 1, 256, 128, 32))
    got = flash_mma(q, k, v, causal=True, window=32)
    mean_v = v[0, 0].mean(dim=0)
    for r in range(159, 256):
        np.testing.assert_allclose(got[0, 0, r].numpy(), mean_v.numpy(),
                                   rtol=1e-5, atol=1e-5)
    # with smaller reference blocks the run limit ends earlier
    got = flash_mma(q, k, v, causal=True, window=32, block_q=32, block_k=32)
    plain = tfa.flash_attention_plain(q, k, v, causal=True, window=32,
                                      block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(
        got.numpy(), _jax_blocks(q, k, v, 32, causal=True, window=32),
        **TOL)


def _jax_blocks(q, k, v, block, **kw):
    return np.asarray(jfa.flash_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), block_q=block,
        block_k=block, **kw))


def test_hi_lo_p_holds_a_short_row_that_one_bf16_p_breaks():
    """Row 1 (causal) sees keys 0 and 1 with probabilities 1 : ~0.998 and
    values 0 and 4: one bf16 rounding of p moves its output by ~4e-3, over
    the 2e-3 bound; the hi + lo pair holds it within 1e-4."""
    q, k, v = _inputs(7, 1, 1, 64, 64, 64)
    k[0, 0, :2] = 0.0
    k[0, 0, 1, 0] = 1.0
    v[0, 0, 0] = 0.0
    v[0, 0, 1] = 4.0
    q[0, 0, 1] = 0.0
    q[0, 0, 1, 0] = _bf16(np.array([math.log(0.998) * 8.0], np.float32))[0]
    exp = _jax(q, k, v, causal=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_mma(tq, tk, tv).numpy()
    one = flash_mma(tq, tk, tv, split_p=False).numpy()
    np.testing.assert_allclose(got, exp, **TOL)
    assert abs(got[0, 0, 1, 0] - exp[0, 0, 1, 0]) < 1e-4
    assert abs(one[0, 0, 1, 0] - exp[0, 0, 1, 0]) > 2e-3
    # row 0 sees one key: p = 1 exactly, the output is that key's V
    np.testing.assert_array_equal(got[0, 0, 0], v[0, 0, 0])


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_shape(hd, dtype):
    """The launch comes from host ints only: rows per block, threads,
    blocks covering L, and shared memory within one block's 232,448 B."""
    params = list(inspect.signature(tfa.launch_shape).parameters)
    assert params == ["L", "hd", "dtype"]
    for L in (1, 63, 64, 65, 200, 2048, 4096):
        s = tfa.launch_shape(L, hd, dtype)
        assert s.rows == 64 and (s.blocks - 1) * 64 < L <= s.blocks * 64
        assert s.smem <= SMEM_PER_BLOCK
        if dtype == torch.bfloat16:    # 4 warps of 16 rows
            assert s.threads == 128
            assert s.smem == ((64 + 2 * tfa.MMA_STAGES * KEY_TILE)
                              * (hd + 8) * 2)
        else:
            assert s.threads == 256


def test_launch_shapes_at_the_suite_widths():
    """qwen2-0.5b (L 2048, hd 64) and gemma3-27b local (L 4096, hd 128)."""
    s = tfa.launch_shape(2048, 64, torch.bfloat16)
    assert (s.threads, s.blocks, s.smem) == (128, 32, 46_080)
    s = tfa.launch_shape(4096, 128, torch.bfloat16)
    assert (s.threads, s.blocks, s.smem) == (128, 64, 87_040)
    s = tfa.launch_shape(2048, 64, torch.float32)
    assert (s.threads, s.blocks, s.smem) == (256, 32, 69_632)


def _bf16_step(x):
    """The spacing of bf16 values at |x| (2^-8 to 2^-7 of |x|), 0 at 0."""
    x = x.float().abs()
    e = torch.floor(torch.log2(x.clamp_min(2.0**-126)))
    return torch.where(x > 0, torch.exp2(e - 7), 0.0)


def _close(out, plain, tol=2e-3):
    """|kernel - plain| <= tol plus, for bf16, one bf16 step of the value
    (both round an f32 result to bf16)."""
    lim = tol + (_bf16_step(plain) if plain.dtype == torch.bfloat16 else 0.0)
    return bool(((out.float() - plain.float()).abs() <= lim).all())


def test_bf16_step_is_the_spacing_of_bf16_values():
    x = torch.tensor([1.0, 1.3046875, 1.9921875, 0.5, -3.0, 0.0])
    step = _bf16_step(x)
    assert step.tolist() == [2**-7, 2**-7, 2**-7, 2**-8, 2**-6, 0.0]
    # the next bf16 value up from |x| is |x| + step
    nxt = (x.abs().bfloat16().view(torch.int16) + 1).view(torch.bfloat16)
    assert torch.equal(step[:5], (nxt.float() - x.abs())[:5])


@pytest.mark.cuda
def test_cuda_flash_mma_matches_its_plain_version():
    """On the card: the tensor-core kernel (bf16, hd 32 / 64 / 128, causal,
    window, softcap, rows that see no key, ragged L and Lk) and the
    CUDA-core kernel (f32) against the plain version within 2e-3 plus one
    bf16 step, eagerly and replayed from a CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_flash_mma.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, L, Lk, hd), causal, window, softcap in CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, H, L, hd, generator=g, device="cuda").to(dtype)
            k, v = (torch.randn(B, H, Lk, hd, generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=softcap,
                      block_q=64, block_k=64)
            out = tfa.flash_attention(q, k, v, **kw)
            plain = tfa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            assert _close(out, plain), (B, H, L, Lk, hd, causal, window,
                                        softcap, dtype)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                g_out = tfa.flash_attention(q, k, v, **kw)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(g_out, out)
