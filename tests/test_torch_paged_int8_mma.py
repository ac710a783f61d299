"""The arithmetic of int8 pages on the tensor-core paged prefill kernel,
held against the JAX reference kernel on the CPU.

csrc/paged_prefill_attention.cu runs int8 pages on the same ``mma.sync``
path as bf16 pages. The CUDA kernel cannot run here, so what it computes
for int8 pages is written out below in plain PyTorch, step for step:

  * int8 rows widened to bf16 (exact: every value in -127..127 is a bf16
    value), 64-key tiles, the key axis split as ``prefill_grid`` splits it
    (the same split as bf16 pages) and merged;
  * q (scaled by 1/sqrt(hd)) fed as a hi + lo pair of bf16 values;
  * column j of S multiplied by ``k_scale[page(j), kh]`` before the mask and
    the softmax; column j of P by ``v_scale[page(j), kh]`` before its hi + lo
    split, the row sum l taking P unscaled.

Inputs are made with numpy from a seed and quantized with the reference's
``kvquant``; the JAX Pallas kernel runs in interpret mode with the scales.
Tolerance rtol = atol = 2e-3, as in the JAX kernel tests. A page whose
scales are 0 (payload left nonzero) gives its keys logit 0 and value 0 on
both sides. The ``cuda``-marked test holds the kernel against its plain
version on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_prefill_attention as jppa
from repro.serve import kvquant
from repro_torch.kernels import paged_decode_attention as tpda
from repro_torch.kernels import paged_prefill_attention as tppa

from test_torch_paged_split import H100_SMS, KEY_TILE, NEG, _hi_lo, \
    merge_splits

TOL = dict(rtol=2e-3, atol=2e-3)


def prefill_mma_int8(q, kq, vq, ks, vs, table, start, tiles_per_split):
    """The tensor-core kernel on int8 pages in plain PyTorch: q [C, H, hd]
    f32, kq / vq [P, K, pt, hd] int8, ks / vs [P, K] f32, table
    [max_pages]."""
    C, H, hd = q.shape
    _, K, pt, _ = kq.shape
    G = H // K
    kd = tpda.gather_pages(kq, table[None])[0].float()     # [K, S, hd]: bf16
    vd = tpda.gather_pages(vq, table[None])[0].float()     # values, exact
    S = kd.shape[1]
    pid = table.clamp_min(0).long()[torch.arange(S) // pt]  # page of a key
    ksk, vsk = ks[pid].T, vs[pid].T                          # [K, S]
    keys = min(start + C, S)
    nsplit = -(-keys // (tiles_per_split * KEY_TILE))
    lim = torch.clamp(start + torch.arange(C * G) // G + 1, max=S)
    out = torch.zeros(C, H, hd)
    for kh in range(K):
        qr = q[:, kh * G:(kh + 1) * G].reshape(C * G, hd).float()
        qh, ql = _hi_lo(qr / math.sqrt(hd))
        pm = torch.full((C * G, nsplit), -math.inf)
        pl = torch.zeros(C * G, nsplit)
        pa = torch.zeros(C * G, nsplit, hd)
        for s in range(nsplit):
            klo = s * tiles_per_split * KEY_TILE
            khi = min(keys, klo + tiles_per_split * KEY_TILE)
            m = torch.full((C * G,), -math.inf)
            l, acc = torch.zeros(C * G), torch.zeros(C * G, hd)
            for kb in range(klo, khi, KEY_TILE):
                n = min(KEY_TILE, khi - kb)
                kt, vt = kd[kh, kb:kb + n], vd[kh, kb:kb + n]
                sc = (qh @ kt.T + ql @ kt.T) * ksk[kh, kb:kb + n]
                vis = (kb + torch.arange(n))[None, :] < lim[:, None]
                sc = torch.where(vis, sc, NEG)
                m_new = torch.maximum(m, sc.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.where(vis, torch.exp(sc - m_new[:, None]), 0.0)
                l = l * corr + p.sum(-1)
                ph, plo = _hi_lo(p * vsk[kh, kb:kb + n])
                acc = acc * corr[:, None] + ph @ vt + plo @ vt
                m = m_new
            pm[:, s] = torch.where(l > 0, m, -math.inf)
            pl[:, s], pa[:, s] = l, acc
        out[:, kh * G:(kh + 1) * G] = merge_splits(pm, pl, pa).reshape(
            C, G, hd)
    return out


def _int8_pool(rng, K, hd, pt, n_keys, max_pages, zero_page=True):
    """An int8 pool quantized by the reference's helpers; the table maps a
    random permutation of pages, and (``zero_page``) the second mapped page
    has zero scales over a payload left as it was."""
    n_pages = max_pages + 2
    rows = [rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32)
            for _ in range(2)]
    (kq, ks), (vq, vs) = [tuple(np.array(a) for a in
                                kvquant.quantize_pages(jnp.asarray(r)))
                          for r in rows]
    table = np.full((max_pages,), -1, np.int32)
    need = -(-n_keys // pt)
    table[:need] = rng.permutation(n_pages)[:need]
    if zero_page and need > 1:
        ks[table[1]] = 0.0
        vs[table[1]] = 0.0
    return kq, vq, ks, vs, table


def _jax(q, kq, vq, ks, vs, table, start):
    return np.asarray(jppa.paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table),
        jnp.asarray(start, jnp.int32), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))


@pytest.mark.parametrize("C,start,pt,hd", [
    (37, 100, 16, 64), (1, 301, 16, 64), (64, 640, 16, 64), (8, 56, 8, 128),
    (64, 3, 8, 128), (5, 11, 4, 32), (9, 20, 4, 16)])
def test_int8_tensor_core_arithmetic_matches_jax(C, start, pt, hd):
    """At the split the wrapper launches with for int8 pages (several
    splits at most of these shapes), pt 4 / 8 / 16, hd 16 to 128, a
    zero-scale page among the visible ones: equal to the JAX kernel with
    scales and to the port's plain version."""
    rng = np.random.default_rng(C * 13 + start + hd)
    H, K = 14, 2
    max_pages = -(-(start + C) // pt) + 1
    kq, vq, ks, vs, table = _int8_pool(rng, K, hd, pt, start + C, max_pages)
    q = rng.standard_normal((C, H, hd)).astype(np.float32)
    g = tppa.prefill_grid(C, H, K, hd, pt, max_pages, start, H100_SMS,
                          torch.int8)
    t = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, table)]
    got = prefill_mma_int8(*t, start, g.tiles_per_split).numpy()
    np.testing.assert_allclose(got, _jax(q, kq, vq, ks, vs, table, start),
                               **TOL)
    plain = tppa.paged_flash_prefill_plain(t[0], t[1], t[2], t[5], start,
                                           k_scale=t[3], v_scale=t[4])
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    assert np.isfinite(got).all()


def test_zero_scale_page_gives_logit_zero_and_value_zero():
    """Only the zero-scale page is visible to the chunk's first row: its
    keys all get logit 0, so the row is the mean of their values, which are
    0 — whatever the int8 payload holds."""
    rng = np.random.default_rng(5)
    H, K, hd, pt = 14, 2, 64, 16
    kq, vq, ks, vs, _ = _int8_pool(rng, K, hd, pt, 64, 6, zero_page=False)
    table = np.array([4, 2, 0, -1, -1, -1], np.int32)
    ks[4] = vs[4] = 0.0
    assert np.abs(kq[4]).max() > 0 and np.abs(vq[4]).max() > 0
    q = rng.standard_normal((3, H, hd)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, table)]
    got = prefill_mma_int8(*t, 5, 1).numpy()
    exp = _jax(q, kq, vq, ks, vs, table, 5)
    np.testing.assert_allclose(got, exp, **TOL)
    np.testing.assert_array_equal(got, np.zeros_like(got))


@pytest.mark.parametrize("C,start,max_pages", [
    (256, 1500, 128), (37, 100, 128), (1, 2047, 128), (256, 0, 128),
    (64, 3, 16), (8, 56, 16)])
def test_int8_pages_split_as_bf16_pages(C, start, max_pages):
    """int8 pages take the tensor-core grid: the same split, blocks and
    scratch as bf16 pages; f32 pages alone keep the CUDA-core grid."""
    H, K, hd, pt = 14, 2, 64, 16
    args = (C, H, K, hd, pt, max_pages, start, H100_SMS)
    assert torch.int8 in tppa.TENSOR_CORE_DTYPES
    assert tppa.prefill_grid(*args, torch.int8) == \
        tppa.prefill_grid(*args, torch.bfloat16)
    f32 = tppa.prefill_grid(*args, torch.float32)
    assert (f32.nsplit, f32.part_ml, f32.part_acc) == (1, 0, 0)
    if (C, start) == (256, 1500):
        assert tppa.prefill_grid(*args, torch.int8).blocks == 280


@pytest.mark.cuda
@pytest.mark.parametrize("pt,hd", [(16, 64), (8, 128), (4, 32)])
def test_cuda_int8_prefill_matches_plain(pt, hd):
    """On the card: int8 pages on the tensor-core kernel against the plain
    version within 2e-3, a zero-scale page among them, eager and replayed
    from a CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_paged_int8_mma.py)")
    rng = np.random.default_rng(hd + pt)
    H, K = 14, 2
    for C, start in ((256, 1500), (37, 100), (1, 2047)):
        max_pages = -(-(start + C) // pt) + 1
        kq, vq, ks, vs, table = _int8_pool(rng, K, hd, pt, start + C,
                                           max_pages)
        q = rng.standard_normal((C, H, hd)).astype(np.float32)
        t = [torch.from_numpy(a).cuda() for a in (q, kq, vq, ks, vs, table)]
        call = (lambda: tppa.paged_flash_prefill(
            t[0], t[1], t[2], t[5], start, k_scale=t[3], v_scale=t[4]))
        n0 = tppa.paged_flash_prefill.launches
        out = call()
        plain = tppa.paged_flash_prefill_plain(
            t[0], t[1], t[2], t[5], start, k_scale=t[3], v_scale=t[4])
        torch.cuda.synchronize()
        assert tppa.paged_flash_prefill.launches == n0 + 1
        assert torch.isfinite(out).all()
        assert (out - plain).abs().max().item() <= 2e-3
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_out = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_out, out)
