"""core/dma.py's 2-D scatter-gather copy against the JAX package's.

  * ``hero_memcpy2d`` on CPU tensors (its plain version, the sequential
    row loop) equals the reference's ``hero_memcpy2d`` run inside an
    interpret-mode ``pallas_call`` (as tests/test_core_properties.py runs
    it) over the same hypothesis ranges, overlapping and zero-stride
    destinations included, for 1-, 2- and 4-byte elements (8-byte ones,
    which JAX takes only under x64, against the reference's numpy oracle
    ``memcpy2d_ref``, which the port's copy of it equals);
  * the paper's tile gather, and the wrapper's refusals;
  * the ``cuda``-marked case holds ``csrc/hero_memcpy2d.cu`` against the
    plain version bit for bit on the card (it skips without one).

JAX is imported inside the CPU cases only, so that the card's run of the
``cuda`` case (``python -m pytest -m cuda tests/test_torch_dma2d.py``)
needs none.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import dma

DTYPES = {np.float32: torch.float32, np.int8: torch.int8,
          np.float16: torch.float16, np.int32: torch.int32}


def _pallas(src, dst_n, rows, elems, ss, ds, so, do):
    """The reference's hero_memcpy2d inside an interpret-mode kernel, on
    the numpy ``src``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from repro.core import dma as jdma

    def kernel(src_ref, dst_ref):
        dst_ref[...] = jnp.zeros_like(dst_ref)
        jdma.hero_memcpy2d(dst_ref, src_ref, rows, elems, ss, ds, so, do)

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((dst_n,), src.dtype),
        interpret=True)(jnp.asarray(src)))


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4), st.integers(1, 8), st.integers(0, 12),
       st.integers(0, 12), st.integers(0, 5), st.integers(0, 5),
       st.integers(0, 2**31), st.sampled_from(sorted(DTYPES, key=str)))
def test_hero_memcpy2d_equals_the_reference_kernel(rows, elems, ss, ds, so,
                                                   do, seed, dt):
    src_n = so + (rows - 1) * ss + elems
    dst_n = do + (rows - 1) * ds + elems
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal(src_n) * 50).astype(dt)
    want = _pallas(src, dst_n, rows, elems, ss, ds, so, do)
    dst = torch.zeros(dst_n, dtype=DTYPES[dt])
    got = dma.hero_memcpy2d(dst, torch.from_numpy(src), rows, elems, ss, ds,
                            so, do)
    assert got is dst
    np.testing.assert_array_equal(got.numpy(), want)
    from repro.core import dma as jdma
    wide = rng.integers(-2**62, 2**62, src_n)          # 8-byte elements
    args = (np.zeros(dst_n, np.int64), wide, rows, elems, ss, ds, so, do)
    want = jdma.memcpy2d_ref(*args)
    np.testing.assert_array_equal(dma.memcpy2d_ref(*args), want)
    got = dma.hero_memcpy2d(torch.zeros(dst_n, dtype=torch.int64),
                            torch.from_numpy(wide), rows, elems, ss, ds, so,
                            do)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tile_gather_and_refusals():
    """A 4×8 tile out of a 16-wide row-major matrix into a packed buffer
    (the reference's test), and a larger one at odd offsets."""
    mat = np.arange(8 * 16, dtype=np.float32)
    got = dma.hero_memcpy2d(torch.zeros(32), torch.from_numpy(mat), 4, 8,
                            16, 8, 2 * 16 + 4, 0)
    np.testing.assert_array_equal(
        got.numpy(), mat.reshape(8, 16)[2:6, 4:12].reshape(-1))
    np.testing.assert_array_equal(
        got.numpy(), _pallas(mat, 32, 4, 8, 16, 8, 36, 0))
    big = torch.arange(64 * 200, dtype=torch.int32)
    out = dma.hero_memcpy2d(torch.zeros(50 * 101, dtype=torch.int32), big,
                            50, 101, 200, 101, 3 * 200 + 7, 0)
    assert torch.equal(out.view(50, 101), big.view(64, 200)[3:53, 7:108])
    meta = dma.hero_memcpy2d(torch.empty(32, device="meta"),
                             torch.empty(128, device="meta"), 4, 8, 16, 8)
    assert meta.shape == (32,) and meta.device.type == "meta"
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="shares its storage"):
        dma.hero_memcpy2d(x[:32], x[32:], 4, 8, 8, 8)
    with pytest.raises(ValueError, match="run past"):
        dma.hero_memcpy2d(torch.zeros(16), torch.zeros(64), 4, 8, 8, 8)
    with pytest.raises(TypeError, match="dtype"):
        dma.hero_memcpy2d(torch.zeros(8), torch.zeros(8, dtype=torch.int32),
                          1, 8, 0, 0)
    with pytest.raises(ValueError, match=">= 0"):
        dma.hero_memcpy2d(torch.zeros(8), torch.zeros(8), 1, 8, -1, 0)


@pytest.mark.cuda
def test_cuda_hero_memcpy2d_matches_its_plain_version():
    """On the card: the kernel equals the row loop bit for bit (aligned
    tile gather, unaligned bf16 / int8 / f64 rows, overlapping and
    zero-stride destinations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_dma2d.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = ((torch.float32, 512, 1024, 2048, 1024, 512, 0),
             (torch.bfloat16, 33, 1001, 1003, 1005, 3, 5),
             (torch.int8, 40, 1001, 1013, 1001, 7, 1),
             (torch.float64, 9, 999, 1000, 1001, 1, 3),
             (torch.bfloat16, 16, 1001, 1003, 700, 1, 2),
             (torch.float32, 9, 5000, 5100, 0, 4, 1))
    before = dma.hero_memcpy2d.launches
    for dt, rows, elems, ss, ds, so, do in cases:
        src = torch.randint(-100, 100, (so + (rows - 1) * ss + elems,),
                            generator=g, device="cuda").to(dt)
        dst = torch.zeros(do + (rows - 1) * ds + elems, dtype=dt,
                          device="cuda")
        want = dma.hero_memcpy2d_plain(dst.clone(), src, rows, elems, ss,
                                       ds, so, do)
        got = dma.hero_memcpy2d(dst, src, rows, elems, ss, ds, so, do)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert dma.hero_memcpy2d.launches == before + len(cases)
