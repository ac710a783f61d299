"""core/addrspace.py against the JAX package's: the promotion analysis,
the (hi, lo) int32 words (split64 / combine32 round trips, Addr64.add
with carries against an int64 oracle and the reference's Addr64), the
legalized gathers (legalized_flat_gather's 16-bit-limb long division
against the reference's over (flat, C < 2^15), legalized_take against
jnp.take), and the embedding's lookup through legalized_take."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import addrspace as jaddr
from repro_torch.core import addrspace
from repro_torch.models import blocks

SET = settings(max_examples=60, deadline=None)
U64 = st.integers(min_value=0, max_value=2**62 - 1)


@SET
@given(U64)
def test_split_combine_round_trip_and_the_reference_s_words(x):
    hi, lo = addrspace.split64(np.int64(x))
    jhi, jlo = jaddr.split64(np.int64(x))
    assert (int(hi), int(lo)) == (int(jhi), int(jlo))
    assert int(addrspace.combine32(hi, lo)) == x
    a = addrspace.Addr64.from_int(x)
    assert a.hi.dtype == a.lo.dtype == torch.int32
    assert int(a.hi) == int(hi) and int(a.lo) & 0xFFFFFFFF == int(lo)


@SET
@given(st.lists(st.tuples(U64, U64), min_size=1, max_size=8))
def test_addr64_add_carries_like_int64_and_the_reference(pairs):
    xs = [x for x, _ in pairs]
    ys = [y for _, y in pairs]
    a, b = addrspace.Addr64.from_int(xs), addrspace.Addr64.from_int(ys)
    s = a.add(b)
    assert s.hi.dtype == s.lo.dtype == torch.int32
    got = addrspace.combine32(s.hi.numpy(), s.lo.numpy())
    assert [int(g) for g in got] == [x + y for x, y in pairs]
    ja = jaddr.Addr64.from_parts(a.hi.numpy(), a.lo.numpy())
    jb = jaddr.Addr64.from_parts(b.hi.numpy(), b.lo.numpy())
    js = ja.add(jb)
    np.testing.assert_array_equal(np.asarray(js.hi), s.hi.numpy())
    np.testing.assert_array_equal(np.asarray(js.lo), s.lo.numpy())
    k = np.int32(ys[0] & 0x7FFFFFFF)
    t = a.add_int32(int(k))
    jt = ja.add_int32(jnp.int32(k))
    np.testing.assert_array_equal(np.asarray(jt.hi), t.hi.numpy())
    np.testing.assert_array_equal(np.asarray(jt.lo), t.lo.numpy())


@SET
@given(st.lists(st.integers(0, 2**40), min_size=1, max_size=6),
       st.integers(1, 2**15 - 1))
def test_legalized_flat_gather_equals_the_reference(flats, C):
    rows = 64
    table = np.arange(rows * C, dtype=np.float32).reshape(rows, C)
    flat = np.asarray(flats, np.int64) % (rows * C)
    hi, lo = addrspace.split64(flat)
    a = addrspace.Addr64.from_int(flat)
    got = addrspace.legalized_flat_gather(torch.from_numpy(table), a.hi,
                                          a.lo)
    want = jaddr.legalized_flat_gather(
        jnp.asarray(table), jnp.asarray(hi, jnp.int32),
        jnp.asarray(lo % (1 << 32), jnp.uint32).astype(jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), flat.astype(np.float32))


@settings(max_examples=40, deadline=None)
@given(st.tuples(st.integers(1, 1 << 17), st.integers(1, 1 << 15)),
       st.sampled_from([1, 2, 4]))
def test_promotion_analysis_is_the_reference_s(shape, itemsize):
    assert addrspace.needs_promotion(shape, itemsize) == \
        jaddr.needs_promotion(shape, itemsize)
    assert addrspace.address_space(shape, itemsize) == \
        jaddr.address_space(shape, itemsize)
    assert str(addrspace.index_dtype(shape, itemsize)).removeprefix(
        "torch.") == np.dtype(jaddr.index_dtype(shape, itemsize)).name


def test_legalized_take_and_the_embedding_lookup():
    emb = (262144, 5376)            # gemma3-27b: the motivating case
    assert addrspace.index_dtype(emb[:1]) == torch.int32
    assert addrspace.needs_promotion(emb, itemsize=4)
    assert (addrspace.NATIVE, addrspace.HOST) == (jaddr.NATIVE, jaddr.HOST)
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 5))
    got = addrspace.legalized_take(torch.from_numpy(table),
                                   torch.from_numpy(ids))
    want = jaddr.legalized_take(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        blocks.embed_lookup(torch.from_numpy(table),
                            torch.from_numpy(ids)).numpy(), np.asarray(want))
    assert not addrspace.legal_flat_gather_possible((4, 2**15))
    with pytest.raises(ValueError, match="2\\^15"):
        addrspace.legalized_flat_gather(torch.zeros(2, 2**15),
                                        torch.zeros(1, dtype=torch.int32),
                                        torch.zeros(1, dtype=torch.int32))
