"""The port's paged attention kernels against the JAX reference kernels.

Inputs are made with numpy from a seed and go through both packages: the
JAX Pallas kernels in interpret mode (as tests/test_kernels.py runs them)
and their oracles, and the port's wrappers on CPU tensors, which take the
kernels' plain PyTorch versions. Tolerance rtol = atol = 2e-3, as in the
JAX kernel tests. The CUDA kernels themselves are held against the same
plain versions on the card by chip_smoke.py and by the ``cuda``-marked test
in tests/test_torch_engine.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_decode_attention as jpda
from repro.kernels import paged_prefill_attention as jppa
from repro.kernels import ref as jref
from repro.serve import kvquant
from repro_torch.kernels import paged_decode_attention as tpda
from repro_torch.kernels import paged_prefill_attention as tppa
from repro_torch.kernels import ref as tref
from repro_torch.serve.paged_step import scatter_chunk

TOL = dict(rtol=2e-3, atol=2e-3)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _paged_setup(rng, B, K, hd, pt, n_pages, lengths):
    """Random page pools + per-slot page tables over shuffled pages."""
    kp = rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32)
    max_pages = max(1, max(-(-int(n) // pt) for n in lengths))
    table = np.full((B, max_pages), -1, np.int32)
    perm = rng.permutation(n_pages)
    i = 0
    for b in range(B):
        need = -(-int(lengths[b]) // pt)
        table[b, :need] = perm[i:i + need]
        i += need
    assert i <= n_pages, "test setup: not enough physical pages"
    return kp, vp, table


def _prefill_setup(rng, K, hd, pt, n_pages, S, max_pages):
    kp = rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32)
    table = np.full((max_pages,), -1, np.int32)
    need = -(-S // pt)
    table[:need] = rng.permutation(n_pages)[:need]
    return kp, vp, table


@pytest.mark.parametrize("B,H,K,hd", [(2, 8, 2, 64), (1, 4, 4, 128),
                                      (3, 6, 3, 64), (2, 6, 2, 32)],
                         ids=["G4", "G1", "G2", "G3"])
@pytest.mark.parametrize("pt", [8, 16, 64])
def test_paged_decode_matches_jax(B, H, K, hd, pt):
    """Ragged lengths × GQA group counts × page sizes: the port's decode
    against the JAX Pallas kernel and the JAX oracle."""
    rng = np.random.default_rng(B * 1000 + pt + H)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    lengths = rng.integers(1, 160, B).astype(np.int32)
    kp, vp, table = _paged_setup(rng, B, K, hd, pt, 96, lengths)
    got = tpda.paged_flash_decode(*_t(q, kp, vp, table, lengths)).numpy()
    kern = jpda.paged_flash_decode(*_j(q, kp, vp, table, lengths))
    orac = jpda.paged_decode_attention_ref(*_j(q, kp, vp, table, lengths))
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    np.testing.assert_allclose(got, np.asarray(orac), **TOL)
    # the port's own oracle agrees too
    tor = tpda.paged_decode_attention_ref(*_t(q, kp, vp, table, lengths))
    np.testing.assert_allclose(got, tor.numpy(), **TOL)


def test_paged_decode_page_boundaries_and_empty_slot():
    """Lengths on page boundaries, one-token slots and a length-0 slot: the
    empty slot gives zeros (the kernel contract), the rest match JAX."""
    rng = np.random.default_rng(7)
    B, H, K, hd, pt = 5, 4, 2, 32, 8
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    lengths = np.array([1, pt, 2 * pt, 3 * pt - 1, 0], np.int32)
    kp, vp, table = _paged_setup(rng, B, K, hd, pt, 32, lengths)
    got = tpda.paged_flash_decode(*_t(q, kp, vp, table, lengths)).numpy()
    kern = np.asarray(jpda.paged_flash_decode(*_j(q, kp, vp, table,
                                                 lengths)))
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_array_equal(got[4], np.zeros((H, hd), np.float32))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("C,start", [(1, 0), (1, 13), (3, 5), (3, 0),
                                     (8, 8), (5, 11), (12, 3)])
def test_paged_prefill_matches_jax(C, start):
    """Chunk sizes 1 / 3 / budget, starts on and off page boundaries."""
    rng = np.random.default_rng(C * 100 + start)
    K, H, hd, pt = 2, 4, 32, 8
    kp, vp, table = _prefill_setup(rng, K, hd, pt, 24, start + C, 6)
    q = rng.standard_normal((C, H, hd)).astype(np.float32)
    got = tppa.paged_flash_prefill(*_t(q, kp, vp, table), start).numpy()
    kern = jppa.paged_flash_prefill(*_j(q, kp, vp, table),
                                    jnp.asarray(start, jnp.int32))
    orac = jppa.paged_prefill_attention_ref(*_j(q, kp, vp, table), start)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    np.testing.assert_allclose(got, np.asarray(orac), **TOL)


@pytest.mark.parametrize("chunks", [[1] * 14, [3, 3, 3, 3, 2], [8, 6],
                                    [14], [5, 1, 8]],
                         ids=["ones", "threes", "budget8", "single", "ragged"])
def test_paged_prefill_chunked_matches_single_shot(chunks):
    """Prefilling in chunks (the port's scatter_chunk + prefill) equals one
    causal pass (the JAX ref.attention) and lands the prompt's K/V in the
    pages exactly."""
    rng = np.random.default_rng(42)
    K, H, hd, pt = 2, 4, 32, 8
    S, G = sum(chunks), H // K
    kp, vp, table = _prefill_setup(rng, K, hd, pt, 16, S, 4)
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    k = rng.standard_normal((S, K, hd)).astype(np.float32)
    v = rng.standard_normal((S, K, hd)).astype(np.float32)
    tkp, tvp, ttab, tq, tk, tv = _t(kp.copy(), vp.copy(), table, q, k, v)
    outs, start = [], 0
    for C in chunks:
        sl = slice(start, start + C)
        scatter_chunk(tkp, tk[sl], ttab, start, pt)
        scatter_chunk(tvp, tv[sl], ttab, start, pt)
        outs.append(tppa.paged_flash_prefill(tq[sl], tkp, tvp, ttab, start))
        start += C
    got = torch.cat(outs).numpy()
    qb = jnp.transpose(q, (1, 0, 2))[None]
    kb = jnp.repeat(jnp.transpose(k, (1, 0, 2)), G, axis=0)[None]
    vb = jnp.repeat(jnp.transpose(v, (1, 0, 2)), G, axis=0)[None]
    exp = jnp.transpose(jref.attention(qb, kb, vb, causal=True)[0],
                        (1, 0, 2))
    np.testing.assert_allclose(got, np.asarray(exp), **TOL)
    # and the port's own dense oracle agrees with the JAX one
    tex = tref.attention(*_t(np.asarray(qb), np.asarray(kb), np.asarray(vb)))
    np.testing.assert_allclose(tex.numpy(), np.asarray(
        jref.attention(qb, kb, vb)), rtol=1e-5, atol=1e-5)
    dense = tpda.gather_pages(tkp, ttab[None])[0][:, :S]
    np.testing.assert_array_equal(dense.numpy(), np.transpose(k, (1, 0, 2)))


def test_paged_prefill_chunk_boundary_mid_page():
    """13 tokens split mid-page at 6: both chunks match the oracle."""
    rng = np.random.default_rng(9)
    K, H, hd, pt = 2, 4, 32, 8
    kp, vp, table = _prefill_setup(rng, K, hd, pt, 8, 13, 2)
    for C, start in [(6, 0), (7, 6)]:
        q = rng.standard_normal((C, H, hd)).astype(np.float32)
        got = tppa.paged_flash_prefill(*_t(q, kp, vp, table), start)
        exp = jppa.paged_prefill_attention_ref(*_j(q, kp, vp, table), start)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def _quantized(kp, vp):
    kq, ks = kvquant.quantize_pages(jnp.asarray(kp))
    vq, vs = kvquant.quantize_pages(jnp.asarray(vp))
    return [np.asarray(a) for a in (kq, ks, vq, vs)]


def test_paged_decode_int8_pages_match_jax():
    rng = np.random.default_rng(21)
    B, H, K, hd, pt = 3, 6, 3, 64, 8
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    lengths = rng.integers(1, 100, B).astype(np.int32)
    kp, vp, table = _paged_setup(rng, B, K, hd, pt, 64, lengths)
    kq, ks, vq, vs = _quantized(kp, vp)
    tq, tkq, tvq, ttab, tlen, tks, tvs = _t(q, kq, vq, table, lengths, ks, vs)
    got = tpda.paged_flash_decode(tq, tkq, tvq, ttab, tlen, k_scale=tks,
                                  v_scale=tvs).numpy()
    kern = jpda.paged_flash_decode(*_j(q, kq, vq, table, lengths),
                                   k_scale=jnp.asarray(ks),
                                   v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    full = tpda.paged_flash_decode(*_t(q, kp, vp, table, lengths)).numpy()
    assert np.abs(got - full).max() < 0.15


def test_paged_prefill_int8_pages_match_jax():
    rng = np.random.default_rng(22)
    K, H, hd, pt, C, start = 2, 4, 32, 8, 5, 11
    kp, vp, table = _prefill_setup(rng, K, hd, pt, 24, start + C, 6)
    kq, ks, vq, vs = _quantized(kp, vp)
    q = rng.standard_normal((C, H, hd)).astype(np.float32)
    tq, tkq, tvq, ttab, tks, tvs = _t(q, kq, vq, table, ks, vs)
    got = tppa.paged_flash_prefill(tq, tkq, tvq, ttab, start, k_scale=tks,
                                   v_scale=tvs).numpy()
    exp = jppa.paged_prefill_attention_ref(
        *_j(q, kq, vq, table), start, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(got, np.asarray(exp), **TOL)


def test_lone_scale_raises_value_error():
    rng = np.random.default_rng(23)
    B, H, K, hd, pt = 1, 2, 1, 16, 4
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    lengths = np.array([4], np.int32)
    kp, vp, table = _paged_setup(rng, B, K, hd, pt, 4, lengths)
    tq, tkp, tvp, ttab, tlen = _t(q, kp, vp, table, lengths)
    ks = torch.ones((4, K))
    with pytest.raises(ValueError):
        tpda.paged_flash_decode(tq, tkp, tvp, ttab, tlen, k_scale=ks)
    with pytest.raises(ValueError):
        tppa.paged_flash_prefill(tq[0], tkp, tvp, ttab[0], 0, v_scale=ks)


def test_cpu_tensors_take_the_plain_version():
    """A CPU call is the plain version and never counts as a launch."""
    rng = np.random.default_rng(5)
    B, H, K, hd, pt = 2, 4, 2, 16, 8
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    lengths = np.array([3, 17], np.int32)
    kp, vp, table = _paged_setup(rng, B, K, hd, pt, 8, lengths)
    before = (tpda.paged_flash_decode.launches,
              tppa.paged_flash_prefill.launches)
    args = _t(q, kp, vp, table, lengths)
    out = tpda.paged_flash_decode(*args)
    plain = tpda.paged_flash_decode_plain(*args)
    assert torch.equal(out, plain)
    chunk = tppa.paged_flash_prefill(args[0], args[1], args[2], args[3][1], 3)
    assert torch.equal(chunk, tppa.paged_flash_prefill_plain(
        args[0], args[1], args[2], args[3][1], 3))
    assert (tpda.paged_flash_decode.launches,
            tppa.paged_flash_prefill.launches) == before == (0, 0)
