"""xlstm-1.3b in the port against the JAX package: mLSTM and sLSTM layers,
their state in the dense slot caches, the dense engine.

At the f32 smoke config (7 mLSTM + 1 sLSTM layers, d_model 64, chunk 32)
with the reference's ``PRNGKey(0)`` weights carried across by
``models/convert.py`` (norm scales perturbed for the forward and step
tests):

  * the config, the full-width count (3,502,733,312, from shapes), the
    caches' shapes and dtypes, the pool's bytes at full width
    (5,652,086,784, constant in max_seq), every leaf converted;
  * ``forward`` and train/step.py's prefill / decode steps against JAX's,
    logits within 1e-4;
  * the dense engine against the JAX dense engine where the reference is
    sound (every request in a fresh slot), and against a greedy loop over
    the JAX no-cache forward on ragged and slot-reuse mixes;
  * the reference's state leak into a reused slot, pinned;
  * the paged, chunked, int8, tiered, prefix and tp engines and the CLI
    refusing the arch in the reference's words before any weight is drawn.
"""
import dataclasses

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

ARCH = "xlstm-1.3b"


def test_config_is_the_references():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in ("name", "family", "d_model", "n_heads", "n_kv", "d_ff",
                  "vocab", "groups", "rope_theta", "tie_embeddings", "remat"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        for f in ("mlstm", "slstm"):
            assert dataclasses.asdict(getattr(t, f)) == \
                dataclasses.asdict(getattr(j, f)), (get, f)
    full = tconfigs.get_config(ARCH)
    assert (full.n_layers(), full.d_model, full.mlstm.head_dim,
            full.slstm.head_dim) == (48, 2048, 1024, 512)


def test_full_width_count_and_pool_bytes_on_meta():
    """3,502,733,312 parameters, as the reference's abstract shapes count
    (w_if drawn in f32 under bf16, as the reference draws it); the 8 x
    2048 slot pool holds 5,652,086,784 B of state, the mLSTM states 42 x 8
    x 4 x 1024 x 1025 x 4 B of them, whatever max_seq is; the reference's
    token estimate counts none of it."""
    cfg = tconfigs.get_config(ARCH, param_dtype=torch.bfloat16)
    model = ttransformer.init_model(cfg, None, "meta")
    n = ttransformer.count_params(model)
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(
            k, jconfigs.get_config(ARCH, param_dtype=jnp.bfloat16)))[0],
        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes))
    assert n == 3_502_733_312
    w_if = model.groups[0][0].mixer["w_if"]
    assert w_if.dtype == torch.float32
    assert shapes["groups"][0][0]["mixer"]["w_if"].dtype == jnp.float32
    for max_seq in (2048, 64):
        pool = CachePool(cfg, 8, max_seq, device="meta")
        assert pool.leaf_nbytes() == 5_652_086_784
    assert 42 * 8 * 4 * 1024 * 1025 * 4 == 5_642_649_600
    assert token_bytes(cfg) == jtoken_bytes(jconfigs.get_config(ARCH)) == 0


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
                assert not tl[name].any()


def test_convert_carries_every_leaf():
    """Every leaf of the reference tree lands in the port's module, equal,
    at its dtype, and the module has no other."""
    tree = arch_weights(ARCH, True)[2]
    model = arch_model(ARCH, True)
    names = dict(model.named_parameters())
    for gi, gp in enumerate(tree["groups"]):
        for i, pos in enumerate(gp):
            stack = model.groups[gi][i]
            assert set(pos) == set(stack.unit(0))
            assert "ffn" not in pos and "ln2" not in pos
            for name, leaf in pos["mixer"].items():
                np.testing.assert_array_equal(
                    stack.mixer[name].numpy(), leaf)
            np.testing.assert_array_equal(stack.ln1.numpy(),
                                          pos["ln1"]["scale"])
    n_tree = sum(a.size for a in jax.tree_util.tree_leaves(tree))
    assert n_tree == sum(p.numel() for p in names.values())
    assert model.shared_block is None


@pytest.fixture(scope="module")
def perturbed():
    return arch_weights(ARCH, True), arch_model(ARCH, True)


def test_forward_prefill_then_decode_matches_jax(perturbed):
    """Two slots prefill 40 tokens (two chunks of 32, the second ragged),
    then 3 decode steps: logits within 1e-4, and every state leaf against
    JAX's within 1e-4 (absolute and relative: after 8 layers a state
    element near 0 can part by a few 1e-5)."""
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
    ``make_prefill_step`` / ``make_decode_step`` (scalar positions):
    logits within 1e-4 at every step, the same greedy tokens."""
    (cfg, params, _, tcfg), model = perturbed
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12))
    jpre, jdec = jax_prefill(cfg), jax_decode(cfg)
    tpre, tdec = tstep.make_prefill_step(tcfg), tstep.make_decode_step(tcfg)
    jl, jc = jpre(params, jnp.asarray(toks, jnp.int32),
                  jtransformer.init_caches(cfg, 2, 32))
    tl, tc = tpre(model, torch.from_numpy(toks),
                  ttransformer.init_caches(tcfg, 2, 32))
    for pos in range(12, 18):
        close(tl, jl, rtol=0, atol=1e-4)
        nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        assert (tl[:, -1].argmax(-1).numpy()[:, None] == nxt).all()
        jl, jc = jdec(params, jnp.asarray(nxt, jnp.int32), jc,
                      jnp.asarray(pos, jnp.int32))
        tl, tc = tdec(model, torch.from_numpy(nxt), tc, pos)
    close(tl, jl, rtol=0, atol=1e-4)


def test_attention_calls_list_none():
    """No layer of xlstm-1.3b attends: nothing for chip_smoke.py to walk."""
    assert tstep.attention_calls(tconfigs.get_config(ARCH), 8, 256, 2048,
                                 64) == []


# --------------------------------------------------------------------------
# the dense engine
# --------------------------------------------------------------------------
def test_dense_engine_matches_jax_dense_engine_in_fresh_slots():
    """Prompts of 3, 9, 5 and 12 tokens, each in a slot of its own, all
    admitted before the first decode step (where the reference's state is
    sound; no attention layer, so its shared decode position does not
    matter): the same streams and counters. Equal lengths: the leak test
    below."""
    prompts = prompts_of(ARCH, (3, 9, 5, 12), 1)
    assert port_dense(ARCH, prompts, 6, 4) == jax_dense(ARCH, prompts, 6, 4)


MIXES = {            # (prompt lengths, seed, n_slots, max_seq)
    "ragged": ((3, 9, 5, 12, 20), 1, 4, 64),
    "slot reuse": ((40, 70, 35, 66, 33, 50), 1, 2, 96),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_dense_engine_matches_the_jax_no_cache_forward(mix):
    """Ragged prompts, and more requests than slots (prompts past the
    chunk of 32: state carried across chunks; later requests in reused
    slots): the port's dense engine gives the greedy streams of the JAX
    no-cache forward."""
    lens, seed, n_slots, max_seq = MIXES[mix]
    prompts = prompts_of(ARCH, lens, seed)
    streams, count = port_dense(ARCH, prompts, 6, n_slots, max_seq)
    assert streams == nocache_greedy(ARCH, prompts, 6)
    assert count["prefills"] == len(lens)


def test_the_reference_dense_engine_leaks_ssm_state_into_a_reused_slot():
    """The reference's dense engine starts a prefill from the slot's state
    as it stands (``free_slot`` clears host bookkeeping only, and free
    slots step on token 0): f32 smoke config, ``PRNGKey(0)``, four 8-token
    prompts from ``default_rng(1)``, 6 new tokens. With 4 slots each
    stream equals its request alone; with 2, requests 2 and 3 part. The
    port starts every prefill from a zero state and gives the solo
    streams with 2 slots too."""
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
def test_paged_stacks_refuse_xlstm_in_the_reference_words(stack):
    """Recurrent layers are not pageable: every stack that needs a page
    pool refuses the arch as the reference's pool does, before it builds
    anything."""
    cfg, _, _, tcfg = arch_weights(ARCH)
    with pytest.raises(ValueError) as ref:
        JPagedCachePool(cfg, max_batch=2, max_seq=64, n_pages=8)
    kw = dict(STACKS[stack])
    cache = kw.pop("cache", {})
    with pytest.raises(ValueError) as got:
        TEngine(tcfg, arch_model(ARCH), device="cpu", config=TEngineConfig(
            n_slots=2, max_seq=64, cache=TCacheConfig(**cache), **kw))
    assert str(got.value) == str(ref.value)
    assert "mixer 'mlstm' is not pageable" in str(got.value)


def test_serve_cli_xlstm_on_the_cpu(capsys, monkeypatch):
    """The CLI serves the arch on its default dense engine; every flag that
    asks for pages refuses it with the pool's message before any weight
    is drawn."""
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
              "--slots", "2", "--max-seq", "48", "--max-new", "3",
              "--prompt-len", "5", "--prompt-len-max", "40"]
    serve.main(common)
    out = capsys.readouterr().out
    assert "[serve:dense] 3 requests, 9 tokens" in out
    leaves = CachePool(tconfigs.get_smoke_config(ARCH), 2, 48).leaf_nbytes()
    assert f"(0 B estimated, {leaves} B of leaves)" in out
    drawn = []
    monkeypatch.setattr(ttransformer, "init_model",
                        lambda *a, **k: drawn.append(a))
    for flag in (["--chunked-prefill"], ["--paged"], ["--kv-dtype", "int8"],
                 ["--tp", "2"]):
        with pytest.raises(ValueError, match="'mlstm' is not pageable"):
            serve.main(common + flag)
    assert drawn == []
