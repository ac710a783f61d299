"""zamba2-1.2b in the port against the JAX package: Mamba2 layers and the
weight-shared attention block, the dense engine.

At the f32 smoke config (5 Mamba2 layers + 1 shared site, then 1 Mamba2;
d_model 64, 4 heads MHA, d_state 8, head_dim 16, chunk 32) with the
reference's ``PRNGKey(0)`` weights carried across by ``models/convert.py``
(norm scales, ``D`` and ``dt_bias`` perturbed for the forward and step
tests):

  * the config, the full-width count (951,304,192, from shapes) and pool
    bytes (1,080,229,888), the caches, ``shared_block`` converted leaf for
    leaf with each site keeping only its norms, and the port's init;
  * ``forward`` and train/step.py's steps against JAX's, logits within
    1e-4; ``attention_calls`` lists the shared sites' calls, those the
    steps make, and none for Mamba2 layers;
  * the dense engine against the JAX dense engine on equal prompt lengths
    in fresh slots (the reference decodes every slot at one shared
    position, ROADMAP.md §3), and against a greedy loop over the JAX
    no-cache forward on ragged and slot-reuse mixes; the reference's state
    leak into a reused slot, pinned;
  * every engine that needs pages, and the CLI, refusing the arch in the
    reference's words before any weight is drawn.
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.serve.kvcache import PagedCachePool as JPagedCachePool
from repro.serve.kvcache import token_bytes as jtoken_bytes
from repro_torch import configs as tconfigs
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.kvcache import CachePool, token_bytes
from repro_torch.train import step as tstep
from test_torch_ssm import (arch_model, arch_weights, close,
                            check_the_reference_leaks_state_into_reused_slots,
                            jax_decode, jax_dense, jax_prefill,
                            nocache_greedy, port_dense, prompts_of)

ARCH = "zamba2-1.2b"


def test_config_is_the_references():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in ("name", "family", "d_model", "n_heads", "n_kv", "d_ff",
                  "vocab", "groups", "rope_theta", "tie_embeddings", "remat",
                  "q_chunk", "kv_chunk", "shard_kv_seq", "hd"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert dataclasses.asdict(t.mamba) == dataclasses.asdict(j.mamba)
        assert t.window_of("shared") == j.attn_cfg("shared").window is None
    full = tconfigs.get_config(ARCH)
    kinds = Counter(k for p, c in full.groups for _ in range(c) for k in p)
    assert kinds == {"mamba:none": 32, "shared:mlp": 6}
    assert (full.n_layers(), full.mamba.n_heads, full.hd) == (38, 64, 64)


def test_full_width_count_and_pool_bytes_on_meta():
    """951,304,192 parameters, as the reference's abstract shapes count
    (one shared block, not six); the 8 x 2048 slot pool holds
    1,080,229,888 B (the 6 sites' K/V, 805,306,368 B, with the Mamba2
    state); ``token_bytes`` is the reference's, the sites alone."""
    cfg = tconfigs.get_config(ARCH, param_dtype=torch.bfloat16)
    model = ttransformer.init_model(cfg, None, "meta")
    n = ttransformer.count_params(model)
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(
            k, jconfigs.get_config(ARCH)))[0], jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes))
    assert n == 951_304_192
    pool = CachePool(cfg, 8, 2048, device="meta")
    assert pool.leaf_nbytes() == 1_080_229_888
    assert token_bytes(cfg) == jtoken_bytes(jconfigs.get_config(ARCH)) == \
        6 * 2 * 32 * 64 * 2
    assert pool.footprint_bytes() == 8 * 2048 * token_bytes(cfg) == \
        805_306_368


def test_caches_are_the_references():
    cfg, _, _, tcfg = arch_weights(ARCH)
    ref = jax.eval_shape(lambda: jtransformer.init_caches(cfg, 3, 16))
    got = ttransformer.init_caches(tcfg, 3, 16)
    for jg, tg in zip(ref, got):
        for jl, tl in zip(jg, tg):
            assert set(jl) == set(tl)
            for name in jl:
                assert tuple(tl[name].shape) == jl[name].shape, name
                assert str(tl[name].dtype)[6:] == str(jl[name].dtype), name


def test_convert_carries_the_shared_block_and_the_sites_norms():
    """``shared_block.{mixer, ffn}`` land leaf for leaf in the module's
    ``shared_block``; a site's stack holds only ``ln1`` / ``ln2``, and
    ``units`` hands each site the shared weights with its own norms."""
    tree = arch_weights(ARCH, True)[2]
    model = arch_model(ARCH, True)
    for part in ("mixer", "ffn"):
        got = getattr(model.shared_block, part)
        assert set(got) == set(tree["shared_block"][part])
        for name, leaf in tree["shared_block"][part].items():
            np.testing.assert_array_equal(got[name].numpy(), leaf)
    site = model.groups[0][5]
    assert site.mixer is None and not site.has_ffn
    assert set(tree["groups"][0][5]) == {"ln1", "ln2"}
    np.testing.assert_array_equal(site.ln2.numpy(),
                                  tree["groups"][0][5]["ln2"]["scale"])
    caches = ttransformer.init_caches(model.cfg, 1, 8)
    for kind, p, cache in ttransformer.units(model, caches):
        if kind == "shared:mlp":
            assert p["mixer"]["wq"] is model.shared_block.mixer["wq"]
            assert p["ffn"]["w_up"] is model.shared_block.ffn["w_up"]
            assert set(cache) == {"k", "v"}
    n_tree = sum(a.size for a in jax.tree_util.tree_leaves(tree))
    assert n_tree == ttransformer.count_params(model)


def test_init_draws_the_reference_leaves():
    """The port's own init: the reference's tree (names, shapes), the
    shared block at the top level, ``A_log`` = log(linspace(1, 16, H)),
    ``D`` ones and ``dt_bias`` zeros, as the reference's."""
    cfg = tconfigs.get_smoke_config(ARCH)
    model = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    ref = jblocks.split_params(jtransformer.init_model(
        jax.random.PRNGKey(0), jconfigs.get_smoke_config(ARCH)))[0]
    mixer = model.groups[0][0].mixer
    jmixer = ref["groups"][0][0]["mixer"]
    assert {k: tuple(v.shape) for k, v in mixer.items()} == \
        {k: v.shape for k, v in jmixer.items()}
    for name in ("A_log", "D", "dt_bias"):
        close(mixer[name], jmixer[name])
    assert set(model.shared_block.mixer) == set(ref["shared_block"]["mixer"])
    assert set(model.shared_block.ffn) == set(ref["shared_block"]["ffn"])


@pytest.fixture(scope="module")
def perturbed():
    return arch_weights(ARCH, True), arch_model(ARCH, True)


def test_forward_prefill_then_decode_matches_jax(perturbed):
    """Two slots prefill 40 tokens (two chunks of 32), then 3 decode steps:
    logits within 1e-4, every cache leaf (the sites' K/V, the Mamba2
    state) within 1e-4 of JAX's."""
    (cfg, params, _, tcfg), model = perturbed
    rng = np.random.default_rng(5)
    B, L, S = 2, 40, 64
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    jl, jc = jax_prefill(cfg)(params, jnp.asarray(toks),
                              jtransformer.init_caches(cfg, B, S))
    caches = ttransformer.init_caches(tcfg, B, S)
    tl, _ = ttransformer.forward(model, torch.from_numpy(toks), caches, 0,
                                 "prefill")
    close(tl[:, -1], jl[:, -1], rtol=0, atol=1e-4)
    for p in range(L, L + 3):
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jax_decode(cfg)(params, jnp.asarray(nxt), jc,
                                 jnp.asarray(p, jnp.int32))
        tl, _ = ttransformer.forward(model, torch.from_numpy(nxt), caches,
                                     torch.full((B,), p, dtype=torch.int32),
                                     "decode")
        close(tl[:, -1], jl[:, -1], rtol=0, atol=1e-4)
    for jg, tg in zip(jc, caches):
        for jleaf, tleaf in zip(jg, tg):
            for name in jleaf:
                close(tleaf[name], jleaf[name], rtol=1e-4, atol=1e-4)


def test_steps_match_the_jax_steps(perturbed):
    """train/step.py's prefill and 6 decode steps against the reference's
    steps: logits within 1e-4 at every step, the same greedy tokens."""
    (cfg, params, _, tcfg), model = perturbed
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12))
    tpre, tdec = tstep.make_prefill_step(tcfg), tstep.make_decode_step(tcfg)
    jl, jc = jax_prefill(cfg)(params, jnp.asarray(toks, jnp.int32),
                              jtransformer.init_caches(cfg, 2, 32))
    tl, tc = tpre(model, torch.from_numpy(toks),
                  ttransformer.init_caches(tcfg, 2, 32))
    for pos in range(12, 18):
        close(tl, jl, rtol=0, atol=1e-4)
        nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        assert (tl[:, -1].argmax(-1).numpy()[:, None] == nxt).all()
        jl, jc = jax_decode(cfg)(params, jnp.asarray(nxt, jnp.int32), jc,
                                 jnp.asarray(pos, jnp.int32))
        tl, tc = tdec(model, torch.from_numpy(nxt), tc, pos)
    close(tl, jl, rtol=0, atol=1e-4)


def test_attention_calls_are_the_steps_calls(perturbed, monkeypatch):
    """Every ``flash_attention`` / ``flash_decode`` call of a prefill and
    its decode steps is one that ``attention_calls`` lists, as many times:
    the shared sites' (MHA, G 1), none from a Mamba2 layer."""
    (_, _, _, tcfg), model = perturbed
    B, P, S, n_new = 2, 10, 32, 5
    seen = []

    def flash_attention(q, k, v, causal, window=None, softcap=None):
        seen.append(("flash_attention", tuple(q.shape), tuple(k.shape),
                     causal, window, ()))
        return tfa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)

    def flash_decode(q, kc, vc, lengths, softcap=None):
        seen.append(("flash_decode", tuple(q.shape), tuple(kc.shape), False,
                     None, tuple(lengths.tolist())))
        return tda.flash_decode(q, kc, vc, lengths, softcap=softcap)

    monkeypatch.setattr(tattention, "flash_attention", flash_attention)
    monkeypatch.setattr(tattention, "flash_decode", flash_decode)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (B, P))
    logits, caches = tstep.make_prefill_step(tcfg)(
        model, torch.from_numpy(toks), ttransformer.init_caches(tcfg, B, S))
    decode = tstep.make_decode_step(tcfg)
    for pos in range(P, P + n_new - 1):
        logits, caches = decode(model, logits[:, -1].argmax(-1)[:, None],
                                caches, pos)
    calls = tstep.attention_calls(tcfg, B, P, S, n_new)
    assert {c.mixer for c in calls} == {"shared"}
    want = Counter()
    for c in calls:
        assert c.group == 1 and c.layers == 1
        if c.kernel == "flash_attention":
            want[(c.kernel, c.q, c.kv, c.causal, c.window, ())] += c.layers
        for n in c.lengths:
            want[(c.kernel, c.q, c.kv, False, None, (n,) * B)] += c.layers
    assert Counter(seen) == want
    assert sum(c.launches for c in calls) == len(seen) == n_new
    full = tstep.attention_calls(tconfigs.get_config(ARCH), 8, 1326, 2048,
                                 64)
    assert [(c.kernel, c.launches) for c in full] == \
        [("flash_attention", 6), ("flash_decode", 6 * 63)]


# --------------------------------------------------------------------------
# the dense engine
# --------------------------------------------------------------------------
def test_dense_engine_matches_jax_dense_engine_on_equal_lengths():
    """Three 40-token prompts (past the chunk of 32), each in a slot of its
    own, all admitted before the first decode step: every slot at one
    position, where the reference's shared decode position is right. The
    same streams and counters. Four 8-token prompts: the leak test."""
    prompts = prompts_of(ARCH, (40, 40, 40), 2)
    assert port_dense(ARCH, prompts, 5, 4) == jax_dense(ARCH, prompts, 5, 4)


MIXES = {            # (prompt lengths, seed, n_slots, max_seq)
    "ragged": ((3, 9, 5, 12, 20), 1, 4, 64),
    "slot reuse": ((40, 70, 35, 66, 33, 50), 1, 2, 96),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_dense_engine_matches_the_jax_no_cache_forward(mix):
    """Ragged prompts (the shared sites at each slot's own position), and
    more requests than slots (prompts past the chunk: Mamba2 state carried
    across chunks; later requests in reused slots): the port's dense
    engine gives the greedy streams of the JAX no-cache forward."""
    lens, seed, n_slots, max_seq = MIXES[mix]
    prompts = prompts_of(ARCH, lens, seed)
    streams, count = port_dense(ARCH, prompts, 6, n_slots, max_seq)
    assert streams == nocache_greedy(ARCH, prompts, 6)
    assert count["prefills"] == len(lens)


def test_the_reference_dense_engine_leaks_ssm_state_into_a_reused_slot():
    """The reference's dense engine starts a prefill from the slot's
    Mamba2 state and conv history as they stand: f32 smoke config,
    ``PRNGKey(0)``, four 8-token prompts from ``default_rng(1)``, 6 new
    tokens. With 4 slots each stream equals its request alone; with 2,
    requests 2 and 3 part (the sites' K/V rows are masked by length and
    do not leak). The port gives the solo streams with 2 slots too."""
    check_the_reference_leaks_state_into_reused_slots(ARCH)


STACKS = {     # EngineConfig kwargs; each needs a page pool
    "paged": dict(cache=dict(paged=True)),
    "chunked": dict(chunked=True),
    "int8": dict(cache=dict(paged=True, kv_dtype="int8")),
    "tiered": dict(cache=dict(tiered=True)),
    "prefix": dict(cache=dict(prefix=True)),
    "tp": dict(tp=2),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_paged_stacks_refuse_zamba2_in_the_reference_words(stack):
    cfg, _, _, tcfg = arch_weights(ARCH)
    with pytest.raises(ValueError) as ref:
        JPagedCachePool(cfg, max_batch=2, max_seq=64, n_pages=8)
    kw = dict(STACKS[stack])
    cache = kw.pop("cache", {})
    with pytest.raises(ValueError) as got:
        TEngine(tcfg, arch_model(ARCH), device="cpu", config=TEngineConfig(
            n_slots=2, max_seq=64, cache=TCacheConfig(**cache), **kw))
    assert str(got.value) == str(ref.value)
    assert "mixer 'mamba' is not pageable" in str(got.value)


def test_serve_cli_zamba2_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
              "--slots", "2", "--max-seq", "48", "--max-new", "3",
              "--prompt-len", "5", "--prompt-len-max", "40"]
    serve.main(common)
    out = capsys.readouterr().out
    assert "[serve:dense] 3 requests, 9 tokens" in out
    pool = CachePool(tconfigs.get_smoke_config(ARCH), 2, 48)
    assert f"({pool.footprint_bytes()} B estimated, {pool.leaf_nbytes()} " \
        "B of leaves)" in out
    drawn = []
    monkeypatch.setattr(ttransformer, "init_model",
                        lambda *a, **k: drawn.append(a))
    for flag in (["--chunked-prefill"], ["--paged"], ["--kv-dtype", "int8"],
                 ["--tp", "2"]):
        with pytest.raises(ValueError, match="'mamba' is not pageable"):
            serve.main(common + flag)
    assert drawn == []
