"""The port's dense and monolithic paged serving paths against the JAX ones.

Same weights (the reference's, carried across by ``models/convert.py``,
QKV biases perturbed) and seeded inputs through both packages, f32 on the
CPU:

  * ``models/attention.gqa_forward`` and ``models/transformer.forward``,
    prefill and decode, against JAX's, within 1e-5 (layer outputs and
    cache rows) and 1e-4 (logits); a decode at ragged per-slot positions
    against JAX run one slot at a time at its own position;
  * ``PagedCachePool.write_prefill`` bit for bit with JAX's pages and int8
    scales, and with the port's chunk scatter;
  * the dense engine against the JAX dense engine on equal-length mixes
    (``tests/test_system.py:207``'s) and on single requests;
  * the dense engine and the monolithic paged engine (paged, int8, tiered
    stacks) against the JAX paged engine on a ragged mix: equal streams and
    counters. The JAX dense engine runs every slot at one shared position
    (``repro/serve/scheduler.py:466-469``), so on this mix it parts from
    its own paged engine; a test pins that;
  * ``stats_summary()`` of idle engines, and the CLI's modes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.kvcache import PagedCachePool as JPagedCachePool
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import paged_step as tstep
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.kvcache import CachePool, PagedCachePool

from test_torch_model import _weights

COUNTERS = ("decode_steps", "decode_tokens", "prefills", "admission_refusals",
            "preemptions", "swap_out_count", "swap_in_count",
            "swap_out_bytes", "swap_in_bytes", "evictions_reprefill",
            "token_fetches", "tokens_fetched", "peak_used_bytes")


@functools.lru_cache(maxsize=None)
def _w():
    return _weights()


@functools.lru_cache(maxsize=None)
def _model():
    _, _, tree, tcfg = _w()
    return params_from_numpy(tree, tcfg)


def _mixer(tree):
    return {k: v[0] for k, v in tree["groups"][0][0]["mixer"].items()}


# --------------------------------------------------------------------------
# gqa_forward and forward
# --------------------------------------------------------------------------
def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_gqa_forward_prefill_matches_jax():
    cfg, _, tree, tcfg = _w()
    rng = np.random.default_rng(3)
    B, L, S = 3, 7, 16
    K, hd = cfg.n_kv, cfg.hd
    m = _mixer(tree)
    x = _rand(rng, B, L, cfg.d_model)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    jy, jc = jattention.gqa_forward(
        jax.tree_util.tree_map(jnp.asarray, m), jnp.asarray(x),
        jnp.asarray(pos), cfg.attn_cfg("gqa"),
        cache={"k": jnp.zeros((B, K, S, hd)), "v": jnp.zeros((B, K, S, hd))},
        cache_pos=jnp.zeros((), jnp.int32))
    cache = {"k": torch.zeros(B, K, S, hd), "v": torch.zeros(B, K, S, hd)}
    ty = tattention.gqa_forward(
        {k: torch.from_numpy(v) for k, v in m.items()}, torch.from_numpy(x),
        torch.from_numpy(pos.copy()), tcfg, cache, 0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5)


def test_gqa_forward_decode_at_per_slot_positions_matches_jax():
    """Slots at positions 4, 9 and 0: the port's one batched step against
    JAX's step run one slot at a time at that slot's position."""
    cfg, _, tree, tcfg = _w()
    rng = np.random.default_rng(4)
    S, K, hd = 16, cfg.n_kv, cfg.hd
    positions = [4, 9, 0]
    B = len(positions)
    m = _mixer(tree)
    x = _rand(rng, B, 1, cfg.d_model)
    kc, vc = _rand(rng, B, K, S, hd), _rand(rng, B, K, S, hd)
    cache = {"k": torch.from_numpy(kc.copy()),
             "v": torch.from_numpy(vc.copy())}
    pos_t = torch.tensor(positions, dtype=torch.int32)
    ty = tattention.gqa_forward(
        {k: torch.from_numpy(v) for k, v in m.items()}, torch.from_numpy(x),
        pos_t.long()[:, None], tcfg, cache, pos_t)
    jm = jax.tree_util.tree_map(jnp.asarray, m)
    for b, p in enumerate(positions):
        jy, jc = jattention.gqa_forward(
            jm, jnp.asarray(x[b:b + 1]), jnp.full((1, 1), p, jnp.int32),
            cfg.attn_cfg("gqa"),
            cache={"k": jnp.asarray(kc[b:b + 1]),
                   "v": jnp.asarray(vc[b:b + 1])},
            cache_pos=jnp.asarray(p, jnp.int32))
        np.testing.assert_allclose(ty[b:b + 1].numpy(), np.asarray(jy),
                                   atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name][b:b + 1].numpy(),
                                       np.asarray(jc[name]), atol=1e-5)


def test_gqa_forward_refuses_what_is_not_ported():
    _, _, tree, tcfg = _w()
    m = {k: torch.from_numpy(v) for k, v in _mixer(tree).items()}
    cache = {"k": torch.zeros(1, 2, 8, 16), "v": torch.zeros(1, 2, 8, 16)}
    h = torch.zeros(1, 2, tcfg.d_model)
    pos = torch.zeros(1, 2, dtype=torch.long)
    import dataclasses
    # a sliding window runs now: a config's window leaves a gqa layer as it
    # is (the reference's attn_cfg gives it to local layers only), and a
    # windowed layer attends over its ring of at most window rows
    plain = tattention.gqa_forward(m, h, pos, tcfg, cache, 0)
    for kw, window in ((dict(window=4), None), ({}, 8)):
        y = tattention.gqa_forward(m, h, pos, dataclasses.replace(tcfg, **kw),
                                   cache, 0, window=window)
        assert y.shape == (1, 2, tcfg.d_model) and torch.equal(y, plain)
    # a softcap runs on the dense path now (tests/test_torch_softcap.py)
    capped = tattention.gqa_forward(
        m, h, pos, dataclasses.replace(tcfg, logit_softcap=30.0), cache, 0)
    assert capped.shape == plain.shape and bool(capped.isfinite().all())
    with pytest.raises(ValueError, match="cache_pos"):
        tattention.gqa_forward(m, h, pos, tcfg, cache, 3)
    with pytest.raises(ValueError, match="one token"):
        tattention.gqa_forward(m, h, pos, tcfg, cache, torch.zeros(1))


def test_forward_prefill_then_ragged_decode_matches_jax():
    """A prefill of two slots, then one decode step with slot 1 at an
    earlier position than slot 0: logits and caches against JAX's (the
    decode one slot at a time)."""
    cfg, params, _, tcfg = _w()
    model = _model()
    rng = np.random.default_rng(5)
    B, L, S = 2, 7, 16
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    jl, jcaches, _ = jtransformer.forward(
        params, jnp.asarray(toks), cfg,
        caches=jtransformer.init_caches(cfg, B, S),
        cache_pos=jnp.zeros((), jnp.int32), mode="prefill")
    caches = ttransformer.init_caches(tcfg, B, S)
    tl, out = ttransformer.forward(model, torch.from_numpy(toks), caches, 0,
                                   "prefill")
    assert out is caches
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    leaf, jleaf = caches[0][0], jcaches[0][0]
    for name in ("k", "v"):
        np.testing.assert_allclose(leaf[name].numpy(), np.asarray(jleaf[name]),
                                   atol=1e-5)
    positions = [L, 3]
    nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    tl, _ = ttransformer.forward(model, torch.from_numpy(nxt), caches,
                                 torch.tensor(positions, dtype=torch.int32),
                                 "decode")
    for b, p in enumerate(positions):
        slot = jax.tree_util.tree_map(lambda a: a[:, b:b + 1], jcaches)
        jl, jc, _ = jtransformer.forward(
            params, jnp.asarray(nxt[b:b + 1]), cfg, caches=slot,
            cache_pos=jnp.asarray(p, jnp.int32), mode="decode")
        np.testing.assert_allclose(tl[b:b + 1].numpy(), np.asarray(jl),
                                   atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(leaf[name][:, b:b + 1].numpy(),
                                       np.asarray(jc[0][0][name]), atol=1e-5)


def test_forward_refuses_bad_modes():
    _, _, _, tcfg = _w()
    model = _model()
    caches = ttransformer.init_caches(tcfg, 1, 8)
    toks = torch.zeros(1, 2, dtype=torch.long)
    with pytest.raises(ValueError, match="position 0"):
        ttransformer.forward(model, toks, caches, 3, "prefill")
    with pytest.raises(ValueError, match="one token"):
        ttransformer.forward(model, toks, caches, torch.zeros(1), "decode")
    with pytest.raises(ValueError, match="mode"):
        ttransformer.forward(model, toks, caches, 0, "train")


# --------------------------------------------------------------------------
# write_prefill
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_write_prefill_bit_for_bit_with_jax(kv_dtype):
    """A dense B = 1 prefill cache of a 19-token prompt (3 pages of 8, the
    last one partial) scattered into the pages a second sequence holds: the
    port's pages and scales equal JAX's bit for bit, and equal the port's
    chunk scatter of the same rows into fresh pages."""
    cfg, _, _, tcfg = _w()
    rng = np.random.default_rng(6)
    L, pt = 19, 8
    kw = dict(max_batch=2, max_seq=32, n_pages=10, page_tokens=pt,
              kv_dtype=kv_dtype)
    jpool = JPagedCachePool(cfg, **kw)
    tpool = PagedCachePool(tcfg, **kw)
    chunk_pool = PagedCachePool(tcfg, **kw)
    for pool in (jpool, tpool, chunk_pool):
        pool.admit(7, 5, 2)                  # page 0 goes to another seq
    count, K, hd = cfg.n_layers(), cfg.n_kv, cfg.hd
    S_p = tpool.padded_len(L)
    assert S_p == 24 == jpool.padded_len(L)
    dense = {n: np.zeros((count, 1, K, S_p, hd), np.float32)
             for n in ("k", "v")}
    for n in dense:
        dense[n][:, :, :, :L] = 3 * _rand(rng, count, 1, K, L, hd)
    slots = [pool.admit(9, L, 4) for pool in (jpool, tpool, chunk_pool)]
    assert slots == [1, 1, 1]
    jpool.write_prefill(1, [({n: jnp.asarray(a) for n, a in dense.items()},)],
                        L)
    tpool.write_prefill(1, [({n: torch.from_numpy(a)
                              for n, a in dense.items()},)], L)
    row = torch.from_numpy(chunk_pool.page_table_row(1))
    for u in range(count):
        kv = {n: a[u] for n, a in chunk_pool.pages[0][0].items()}
        rows = {n: torch.from_numpy(dense[n][u, 0, :, :L]).transpose(0, 1)
                for n in ("k", "v")}
        tstep._write_chunk(kv, rows["k"], rows["v"], row, 0, pt)
    assert tpool.lengths[1] == jpool.lengths[1] == L
    jleaf, tleaf = jpool.pages[0][0], tpool.pages[0][0]
    assert set(tleaf) == set(jleaf)
    for name in tleaf:
        assert np.array_equal(tleaf[name].numpy(), np.asarray(jleaf[name])), \
            name
        assert torch.equal(tleaf[name], chunk_pool.pages[0][0][name]), name
    if kv_dtype == "int8":
        assert tleaf["k"].dtype == torch.int8
        assert (tleaf["k_scale"][:, tpool.alloc._seq_pages[9]] > 0).all()


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------
RAGGED = (3, 9, 5, 12)            # prompt lengths, default_rng(1)


def _prompts(lens, seed):
    cfg = _w()[0]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def _serve(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        assert eng.submit(request_cls(seq_id=i, prompt=p.copy(),
                                      max_new=max_new))
    done = eng.run(max_steps=1000)
    assert eng.idle and len(done) == len(prompts)
    return {int(r.seq_id): list(r.tokens_out) for r in done}


def _jax(cache=None, **kw):
    cfg, params, _, _ = _w()
    return JEngine(cfg, params, config=JEngineConfig(
        cache=JCacheConfig(**(cache or {})), **kw))


def _port(cache=None, **kw):
    tcfg = _w()[3]
    return TEngine(tcfg, _model(), device="cpu", config=TEngineConfig(
        cache=TCacheConfig(**(cache or {})), **kw))


def _counters(eng):
    s = eng.stats_summary()
    return {k: s[k] for k in COUNTERS}


@functools.lru_cache(maxsize=None)
def _jax_run(cache_items, lens, seed, max_new, n_slots):
    eng = _jax(dict(cache_items), n_slots=n_slots, max_seq=64)
    streams = _serve(eng, JRequest, _prompts(lens, seed), max_new)
    return streams, _counters(eng)


EQUAL_MIXES = {            # (prompt lengths, seed, max_new, n_slots)
    "paged_vs_dense": ((6, 6, 6, 6), 1, 5, 2),     # test_system.py:207
    "batched": ((5, 5, 5, 5, 5), 0, 4, 2),         # test_system.py:190
}


@pytest.mark.parametrize("mix", sorted(EQUAL_MIXES))
def test_dense_engine_matches_jax_dense_engine_on_equal_lengths(mix):
    lens, seed, max_new, n_slots = EQUAL_MIXES[mix]
    ref, ref_counts = _jax_run((), lens, seed, max_new, n_slots)
    eng = _port(n_slots=n_slots, max_seq=64)
    assert _serve(eng, TRequest, _prompts(lens, seed), max_new) == ref
    assert _counters(eng) == ref_counts
    assert isinstance(eng.pool, CachePool) and not eng.config.cache.paged
    assert (eng.pool.seq_ids < 0).all() and not eng.pool.lengths.any()
    assert max(eng.stats["batch_occupancy"]) == 1.0


@pytest.mark.parametrize("i", range(len(RAGGED)))
def test_dense_engine_matches_jax_dense_engine_on_single_requests(i):
    prompt = _prompts(RAGGED, 1)[i]
    ref = _serve(_jax(n_slots=4, max_seq=64), JRequest, [prompt], 6)
    got = _serve(_port(n_slots=4, max_seq=64), TRequest, [prompt], 6)
    assert got == ref


STACKS = {        # port engine / JAX paged engine cache configs
    "dense": ((), (("paged", True), ("page_tokens", 8))),
    "paged": ((("paged", True), ("page_tokens", 8)),) * 2,
    "int8": ((("paged", True), ("page_tokens", 8),
              ("kv_dtype", "int8")),) * 2,
    "tiered": ((("paged", True), ("page_tokens", 8), ("tiered", True),
                ("n_pages", 4)),) * 2,
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_engines_match_jax_paged_engine_on_a_ragged_mix(stack):
    """Prompts of 3, 9, 5 and 12 tokens, four slots, six new tokens: the
    port's dense engine and its monolithic paged engine on each stack give
    the JAX monolithic paged engine's streams and counters."""
    port_cache, jax_cache = STACKS[stack]
    ref, ref_counts = _jax_run(jax_cache, RAGGED, 1, 6, 4)
    eng = _port(dict(port_cache), n_slots=4, max_seq=64)
    got = _serve(eng, TRequest, _prompts(RAGGED, 1), 6)
    assert got == ref
    counts = _counters(eng)
    if stack == "dense":       # the dense pool counts no pages
        counts.pop("peak_used_bytes")
        ref_counts = {k: v for k, v in ref_counts.items()
                      if k != "peak_used_bytes"}
    assert counts == ref_counts
    assert eng.config.cache.paged == (stack != "dense")
    assert not eng.config.chunked
    if stack != "dense":
        pool = eng.pool
        assert pool.alloc.free_pages == pool.alloc.n_pages
        assert pool._reserved == {}
        pool.alloc.audit()
    if stack == "tiered":
        assert counts["preemptions"] > 0
        assert eng.pool.cold_seqs() == []


def test_the_reference_dense_engine_parts_from_its_paged_engine():
    """The reference's dense decode runs every slot at one shared position
    (``repro/serve/scheduler.py:466-469``): on the ragged mix its streams
    differ from its paged engine's on every request but the longest, and
    each request served alone gives the paged streams."""
    paged, _ = _jax_run(STACKS["paged"][1], RAGGED, 1, 6, 4)
    dense, _ = _jax_run((), RAGGED, 1, 6, 4)
    longest = int(np.argmax(RAGGED))
    assert dense[longest] == paged[longest]
    assert [i for i in paged if dense[i] != paged[i]] == [0, 1, 2]
    prompts = _prompts(RAGGED, 1)
    for i, p in enumerate(prompts):
        alone = _serve(_jax(n_slots=4, max_seq=64), JRequest, [p], 6)
        assert alone[0] == paged[i]


@pytest.mark.parametrize("cache", [{}, {"paged": True}],
                         ids=["dense", "monolithic"])
def test_stats_summary_empty_engine(cache):
    """``tests/test_system.py:410``: an engine that never served reports
    zeros, never a numpy error."""
    eng = _port(dict(cache, page_tokens=8), n_slots=2, max_seq=32)
    assert eng.run(max_steps=3) == []
    s = eng.stats_summary()
    assert s["decode_steps"] == 0 and s["prefills"] == 0
    assert s["mean_occupancy"] == 0.0
    for p in (50, 90, 99):
        assert s[f"queue_lat_p{p}_s"] == 0.0
        assert s[f"ttft_p{p}_s"] == 0.0
    assert "token_budget" not in s
    for v in s.values():
        assert np.isfinite(v), s


def test_dense_pool_footprint_and_config():
    tcfg = _w()[3]
    from repro_torch import configs
    full = configs.get_config("qwen2-0.5b")
    from repro_torch.serve.kvcache import token_bytes
    assert token_bytes(full) == 12_288
    pool = CachePool(tcfg, 2, 32)
    assert pool.footprint_bytes() == 2 * 32 * token_bytes(tcfg)
    leaf = pool.caches[0][0]["k"]
    assert tuple(leaf.shape) == (tcfg.n_layers(), 2, tcfg.n_kv, 32, tcfg.hd)
    assert leaf.dtype == tcfg.compute_dtype
    assert pool.alloc_slot(5) == 0 and pool.alloc_slot(6) == 1
    with pytest.raises(MemoryError):
        pool.alloc_slot(7)
    pool.free_slot(0)
    assert pool.alloc_slot(8) == 0


def test_serve_cli_dense_and_monolithic_on_the_cpu(capsys):
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--requests", "4", "--slots", "2",
              "--max-seq", "32", "--max-new", "3"]
    serve.main(common)
    out = capsys.readouterr().out
    assert "[serve:dense] 4 requests, 12 tokens" in out
    assert "[serve:dense] pool 2 slots × 32 tok" in out
    serve.main(common + ["--paged", "--page-tokens", "8"])
    out = capsys.readouterr().out
    assert "[serve:paged] 4 requests, 12 tokens" in out
    assert "[serve:paged] pool 8 pages × 8 tok" in out
    assert "token budget" not in out
