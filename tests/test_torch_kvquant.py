"""The port's int8 KV quantization against the JAX reference, bit for bit.

``repro_torch.serve.kvquant`` and the int8 scatters of
``repro_torch.serve.paged_step`` (``scatter_chunk_q``, ``_scatter_token_q``)
must leave exactly the reference's bytes: the same int8 rows and the same
f32 scales, on the same seeded inputs. Inputs are made with numpy; the JAX
side runs on the CPU. The port's scatters write in place, the reference's
return new arrays; both results are compared whole.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kvquant as jkq
from repro.serve import paged_step as jps
from repro_torch.serve import kvquant as tkq
from repro_torch.serve import paged_step as tps

K, PT, HD = 2, 8, 16


def _eq(t: torch.Tensor, j) -> None:
    """Equal bit for bit (dtype, shape, every value)."""
    a = np.asarray(j)
    b = t.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))


def _rows(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _special_rows():
    """[4, K, PT, HD]: page 0 all zeros, page 1 with ties at .5 under a
    scale of exactly 1 (absmax 127), page 2 at the clip, page 3 seeded."""
    r = np.zeros((4, K, PT, HD), np.float32)
    tie = (np.arange(PT * HD).reshape(PT, HD) % 9 - 4).astype(np.float32)
    r[1] = tie + 0.5
    r[1, :, 0, 0] = 127.0
    r[2] = np.where(np.arange(HD) % 2, 127.0, -127.0).astype(np.float32)
    r[2, 1] *= 0.25
    r[3] = _rows(5, (K, PT, HD))
    return r


@pytest.mark.parametrize("case", ["special", "seeded"])
def test_quantize_helpers_equal_jax_bit_for_bit(case):
    """abs_scale, quantize, dequantize, quantize_pages, rescale_ratio and
    requantize on the same arrays: an all-zero page (scale 0 quantizes to 0,
    ratio 0), ties at .5 (half to even), values at the clip, and a rescale
    whose ratio is exactly 1 (a no-op)."""
    rows = _special_rows() if case == "special" else _rows(1, (5, K, PT, HD))
    t = torch.from_numpy(rows)
    _eq(tkq.abs_scale(t), jkq.abs_scale(jnp.asarray(rows)))
    qt, st = tkq.quantize_pages(t)
    qj, sj = jkq.quantize_pages(jnp.asarray(rows))
    _eq(qt, qj)
    _eq(st, sj)
    _eq(tkq.dequantize(qt, st), jkq.dequantize(qj, sj))
    if case == "special":
        assert not qt[0].any() and st[0].eq(0).all()
        assert st[1].eq(1.0).all()                     # ties land at .5
        np.testing.assert_array_equal(
            qt[1, 0, 1].numpy(), np.round(rows[1, 0, 1]).astype(np.int8))
        assert qt[2].abs().max().item() == 127
    # a wider scale, an equal one (ratio exactly 1), a zero one
    new = st * torch.from_numpy(
        np.random.default_rng(2).uniform(1.0, 3.0, st.shape)
        .astype(np.float32))
    new[0] = 0.0
    for target in (new, st):
        rt = tkq.rescale_ratio(st, target)
        rj = jkq.rescale_ratio(sj, jnp.asarray(target.numpy()))
        _eq(rt, rj)
        _eq(tkq.requantize(qt, rt), jkq.requantize(qj, rj))
    same = tkq.rescale_ratio(st, st)
    assert same[st > 0].eq(1.0).all()
    assert torch.equal(tkq.requantize(qt, same), qt)
    assert tkq.rescale_ratio(st, torch.zeros_like(st)).eq(0).all()
    with pytest.raises(ValueError):
        tkq.validate_kv_dtype("fp8")
    assert tkq.KV_DTYPES == jkq.KV_DTYPES and tkq.Q_MAX == jkq.Q_MAX


def _pool(seed, P=10):
    """An int8 pool half written: pages at random scales, two pages fresh
    (scale 0, payload 0)."""
    rows = _rows(seed, (P, K, PT, HD), scale=1.5)
    q, s = (np.asarray(a) for a in jkq.quantize_pages(jnp.asarray(rows)))
    q, s = q.copy(), s.copy()
    q[[3, 7]] = 0
    s[[3, 7]] = 0.0
    return q, s


# name -> (start, C): a chunk that starts mid-page, one that spans three
# pages, a whole fresh page (page 3 of the table maps pool page 3, scale 0),
# a single row
CHUNKS = {"mid_page": (5, 2), "spans_pages": (6, 19), "fresh_page": (24, 8),
          "one_row": (13, 1)}
TABLE = np.array([0, 5, 1, 3, 2, 7, -1, -1], np.int32)


@pytest.mark.parametrize("name", sorted(CHUNKS))
def test_scatter_chunk_q_equals_jax_bit_for_bit(name):
    start, C = CHUNKS[name]
    q, s = _pool(11)
    rows = _rows(12, (C, K, HD), scale=4.0)
    jq, js = jps.scatter_chunk_q(jnp.asarray(q), jnp.asarray(s),
                                 jnp.asarray(rows), jnp.asarray(TABLE),
                                 jnp.asarray(start, jnp.int32), PT)
    tq, ts = torch.from_numpy(q.copy()), torch.from_numpy(s.copy())
    out = tps.scatter_chunk_q(tq, ts, torch.from_numpy(rows),
                              torch.from_numpy(TABLE), start, PT)
    assert out is tq
    _eq(tq, jq)
    _eq(ts, js)
    touched = set(TABLE[np.arange(start, start + C) // PT].tolist())
    for p in set(range(len(q))) - touched:      # untouched pages: as before
        np.testing.assert_array_equal(tq[p].numpy(), q[p])
        np.testing.assert_array_equal(ts[p].numpy(), s[p])
    if name == "fresh_page":                    # a whole page, quantized once
        exp_q, exp_s = jkq.quantize_pages(
            jnp.asarray(np.transpose(rows, (1, 0, 2))[None]))
        np.testing.assert_array_equal(tq[3].numpy(), np.asarray(exp_q)[0])
        np.testing.assert_array_equal(ts[3].numpy(), np.asarray(exp_s)[0])


TOK_TABLE = np.array([[0, 5, 1, -1], [3, -1, -1, -1], [2, 7, -1, -1],
                      [4, 6, 8, 9]], np.int32)


@pytest.mark.parametrize("lengths,active", [
    ((3, 0, 9, 30), (True, True, True, True)),
    ((8, 5, 15, 17), (True, False, True, False)),
    ((0, 0, 0, 0), (False, True, False, False))])
def test_scatter_token_q_equals_jax_bit_for_bit(lengths, active):
    """Inactive slots leave their page and scale rows bit-untouched; active
    ones widen their page's scale and requantize it in the same step."""
    q, s = _pool(21)
    tok = _rows(22, (4, K, HD), scale=2.0)
    tok[0] *= 0.01                  # a write that does not widen the scale
    lens = np.array(lengths, np.int32)
    act = np.array(active)
    jq, js = jps._scatter_token_q(jnp.asarray(q), jnp.asarray(s),
                                  jnp.asarray(tok), jnp.asarray(TOK_TABLE),
                                  jnp.asarray(lens), jnp.asarray(act), PT)
    tq, ts = torch.from_numpy(q.copy()), torch.from_numpy(s.copy())
    tps._scatter_token_q(tq, ts, torch.from_numpy(tok),
                         torch.from_numpy(TOK_TABLE), torch.from_numpy(lens),
                         torch.from_numpy(np.flatnonzero(act)), PT)
    _eq(tq, jq)
    _eq(ts, js)
    for b in np.flatnonzero(~act):
        pid = max(TOK_TABLE[b, lens[b] // PT], 0)
        if not any(act[a] and max(TOK_TABLE[a, lens[a] // PT], 0) == pid
                   for a in range(4)):
            np.testing.assert_array_equal(tq[pid].numpy(), q[pid])
            np.testing.assert_array_equal(ts[pid].numpy(), s[pid])


def test_repeated_writes_do_not_drift():
    """Ten writes of the same chunk and of the same decode token: equal to
    JAX after each, and after the first the page bytes no longer change (the
    scale stops growing, every later rescale is at ratio exactly 1)."""
    q, s = _pool(31)
    rows = _rows(32, (11, K, HD))
    tok = _rows(33, (4, K, HD))
    lens = np.array([20, 2, 1, 20], np.int32)
    act = np.array([True, True, False, True])
    jq, js = jnp.asarray(q), jnp.asarray(s)
    tq, ts = torch.from_numpy(q.copy()), torch.from_numpy(s.copy())
    snaps = []
    for _ in range(10):
        jq, js = jps.scatter_chunk_q(jq, js, jnp.asarray(rows),
                                     jnp.asarray(TABLE),
                                     jnp.asarray(3, jnp.int32), PT)
        jq, js = jps._scatter_token_q(jq, js, jnp.asarray(tok),
                                      jnp.asarray(TOK_TABLE),
                                      jnp.asarray(lens), jnp.asarray(act), PT)
        tps.scatter_chunk_q(tq, ts, torch.from_numpy(rows),
                            torch.from_numpy(TABLE), 3, PT)
        tps._scatter_token_q(tq, ts, torch.from_numpy(tok),
                             torch.from_numpy(TOK_TABLE),
                             torch.from_numpy(lens),
                             torch.from_numpy(np.flatnonzero(act)), PT)
        _eq(tq, jq)
        _eq(ts, js)
        snaps.append((tq.clone(), ts.clone()))
    for a, b in zip(snaps[1:], snaps[2:]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
