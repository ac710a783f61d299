"""yi-34b and minitron-4b in the port against the JAX package, and the
paged kernels' split at kv-head shards.

At each arch's smoke config in f32, with the reference's ``PRNGKey(0)``
weights carried across by ``models/convert.py`` (both archs are untied,
so the ``lm_head`` leaf travels too):

  * ``blocks.relu2_mlp`` against the reference's block (minitron-4b's
    squared-ReLU MLP), within 1e-6;
  * ``transformer.forward``, a prefill then a decode step, against the
    JAX forward's logits within 1e-4;
  * the chunked, monolithic paged and dense engines' greedy streams and
    counters against the JAX engines' (the dense engine on equal-length
    prompts: the reference's dense decode runs every slot at one shared
    position, ROADMAP.md §3).

Host-only: ``decode_grid`` / ``prefill_grid`` choose the same split at
(H/tp, K/tp) as at (H, K), so a head reduces in the same order at any
tp; yi-34b at full width counts 34,388,917,248 parameters on the ``meta``
device, as the reference's abstract shapes do.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.kernels import paged_decode_attention as tpda
from repro_torch.kernels import paged_prefill_attention as tppa
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.engine import Request as TRequest

ARCHS = ("yi-34b", "minitron-4b")
COUNTERS = ("decode_steps", "decode_tokens", "prefills", "prefill_chunks",
            "prefill_chunk_tokens", "admission_refusals", "token_fetches",
            "tokens_fetched")


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = jconfigs.get_smoke_config(arch, compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    tcfg = tconfigs.get_smoke_config(arch, compute_dtype=torch.float32)
    tree = jax.tree_util.tree_map(np.array, params)
    return cfg, params, tree, tcfg


@functools.lru_cache(maxsize=None)
def _model(arch):
    _, _, tree, tcfg = _weights(arch)
    return params_from_numpy(tree, tcfg)


def test_configs_are_the_references():
    for arch in ARCHS:
        for get in ("get_config", "get_smoke_config"):
            j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
            for f in ("name", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
                      "groups", "mlp", "qkv_bias", "rope_theta",
                      "tie_embeddings", "norm", "window", "hd"):
                assert getattr(t, f) == getattr(j, f), (arch, get, f)
    yi = tconfigs.get_config("yi-34b")
    assert (yi.n_layers(), yi.d_model, yi.n_heads, yi.n_kv, yi.hd, yi.d_ff,
            yi.vocab, yi.rope_theta) == (60, 7168, 56, 8, 128, 20480, 64000,
                                         5e6)
    mt = tconfigs.get_config("minitron-4b")
    assert (mt.n_layers(), mt.d_model, mt.n_heads, mt.n_kv, mt.hd, mt.d_ff,
            mt.vocab, mt.mlp) == (32, 3072, 24, 8, 128, 9216, 256000, "relu2")


def test_relu2_mlp_matches_the_reference():
    rng = np.random.default_rng(3)
    w_in = rng.standard_normal((64, 128)).astype(np.float32) / 8
    w_out = rng.standard_normal((128, 64)).astype(np.float32) / 11
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    ref = jblocks.relu2_mlp(jnp.asarray(w_in), jnp.asarray(w_out),
                            jnp.asarray(x))
    got = tblocks.relu2_mlp(*map(torch.from_numpy, (w_in, w_out, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_untied_head_and_the_mlp(arch):
    _, _, tree, tcfg = _weights(arch)
    model = _model(arch)
    assert not tcfg.tie_embeddings and model.lm_head is not None
    np.testing.assert_array_equal(model.lm_head.numpy(), tree["lm_head"])
    assert model.head() is model.lm_head
    ffn = tree["groups"][0][0]["ffn"]
    names = ("w_in", "w_out") if arch == "minitron-4b" else \
        ("w_gate", "w_up", "w_down")
    assert set(ffn) == set(names) == set(model.groups[0][0].ffn)
    for name in names:
        np.testing.assert_array_equal(model.groups[0][0].ffn[name].numpy(),
                                      ffn[name])
    assert "bq" not in model.groups[0][0].mixer     # no QKV bias
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy({k: v for k, v in tree.items() if k != "lm_head"},
                          tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """A 9-token prefill of two slots, then a decode step at position 9:
    logits within 1e-4 of JAX's."""
    cfg, params, _, tcfg = _weights(arch)
    model = _model(arch)
    rng = np.random.default_rng(7)
    B, L, S = 2, 9, 16
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    jl, jc, _ = jtransformer.forward(
        params, jnp.asarray(toks), cfg,
        caches=jtransformer.init_caches(cfg, B, S),
        cache_pos=jnp.zeros((), jnp.int32), mode="prefill")
    caches = ttransformer.init_caches(tcfg, B, S)
    tl, _ = ttransformer.forward(model, torch.from_numpy(toks), caches, 0,
                                 "prefill")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jl, _, _ = jtransformer.forward(
        params, jnp.asarray(nxt), cfg, caches=jc,
        cache_pos=jnp.asarray(L, jnp.int32), mode="decode")
    tl, _ = ttransformer.forward(model, torch.from_numpy(nxt), caches,
                                 torch.full((B,), L, dtype=torch.int32),
                                 "decode")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------
ENGINES = {    # name -> (engine kwargs, cache kwargs, prompt lengths)
    "chunked": (dict(chunked=True, token_budget=8),
                dict(paged=True, page_tokens=8), (6, 13, 3, 9)),
    "monolithic": ({}, dict(paged=True, page_tokens=8), (3, 9, 5, 12)),
    "dense": ({}, {}, (6, 6, 6, 6)),
}


def _prompts(arch, lens):
    vocab = _weights(arch)[0].vocab
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(eng, request_cls, prompts, max_new=5):
    for i, p in enumerate(prompts):
        assert eng.submit(request_cls(seq_id=i, prompt=p.copy(),
                                      max_new=max_new))
    done = eng.run(max_steps=1000)
    assert eng.idle and len(done) == len(prompts)
    s = eng.stats_summary()
    return ({int(r.seq_id): list(r.tokens_out) for r in done},
            {k: s.get(k, 0) for k in COUNTERS})


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_jax_engines(arch, engine):
    cfg, params, _, tcfg = _weights(arch)
    ekw, ckw, lens = ENGINES[engine]
    prompts = _prompts(arch, lens)
    ref = _serve(JEngine(cfg, params, config=JEngineConfig(
        n_slots=2, max_seq=64, cache=JCacheConfig(**ckw), **ekw)),
        JRequest, prompts)
    eng = TEngine(tcfg, _model(arch), device="cpu", config=TEngineConfig(
        n_slots=2, max_seq=64, cache=TCacheConfig(**ckw), **ekw))
    got = _serve(eng, TRequest, prompts)
    assert got == ref
    assert eng.config.chunked == (engine == "chunked")
    assert eng.config.cache.paged == (engine != "dense")
    if engine != "dense":
        assert eng.pool.alloc.free_pages == eng.pool.alloc.n_pages
        eng.pool.alloc.audit()


# --------------------------------------------------------------------------
# host-only: the split at kv-head shards, the full-width shapes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ("qwen2-0.5b",) + ARCHS)
def test_grids_split_as_the_unsharded_call_at_every_tp(arch):
    """The kernels' split (and so each head's reduction order) at a rank's
    (H/tp, K/tp) equals the unsharded call's, at decode and chunk shapes
    over the serving pools, for every tp that divides n_kv; the blocks
    shrink with the shard."""
    cfg = tconfigs.get_config(arch)
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    for tp in (t for t in (1, 2, 4, 8) if K % t == 0):
        for B in (1, 3, 8):
            for max_pages in (8, 128, 256):
                whole = tpda.decode_grid(B, H, K, hd, max_pages, 132)
                shard = tpda.decode_grid(B, H // tp, K // tp, hd, max_pages,
                                         132, shards=tp)
                assert shard[:2] == whole[:2], (arch, tp, B, max_pages)
                assert shard.blocks * tp == whole.blocks
        for C, start in ((1, 0), (37, 100), (256, 0), (256, 1500)):
            for dt in (torch.bfloat16, torch.int8, torch.float32):
                whole = tppa.prefill_grid(C, H, K, hd, 16, 128, start, 132,
                                          dt)
                shard = tppa.prefill_grid(C, H // tp, K // tp, hd, 16, 128,
                                          start, 132, dt, shards=tp)
                assert shard[:2] == whole[:2], (arch, tp, C, start, dt)
                assert shard.blocks * tp == whole.blocks
    # without the unsharded counts a shard would split otherwise: the
    # repair is what keeps tp = 2 on the card equal to tp = 1
    assert tpda.decode_grid(8, 7, 1, 64, 128, 132).nsplit != \
        tpda.decode_grid(8, 14, 2, 64, 128, 132).nsplit


def _reference_count(arch):
    jcfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(k, jcfg))[0],
        jax.random.PRNGKey(0))
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_counts_on_meta(arch):
    """The published widths, counted without allocating: equal to the
    reference's abstract shapes, and 34,388,917,248 for yi-34b (68.8 GB in
    bf16: one 80 GB card)."""
    cfg = tconfigs.get_config(arch, param_dtype=torch.bfloat16)
    model = ttransformer.init_model(cfg, None, "meta")
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16
               for p in model.parameters())
    n = ttransformer.count_params(model)
    assert n == _reference_count(arch)
    if arch == "yi-34b":
        assert n == 34_388_917_248


def test_init_draws_each_stacked_slice_and_casts_once():
    """A bf16 init equals an f32 init cast to bf16 bit for bit (the draw is
    f32 either way, one [count] slice of a stacked leaf at a time), and
    relu2 leaves take the reference's N(0, 1/fan_in)."""
    cfg = tconfigs.get_smoke_config("minitron-4b", d_model=256, d_ff=512)
    f32 = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    bf16 = ttransformer.init_model(
        tconfigs.get_smoke_config("minitron-4b", d_model=256, d_ff=512,
                                  param_dtype=torch.bfloat16),
        torch.Generator().manual_seed(0))
    for (name, a), (_, b) in zip(f32.named_parameters(),
                                 bf16.named_parameters()):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b), name
    ffn = f32.groups[0][0].ffn
    assert abs(ffn["w_in"].std().item() * 256 ** 0.5 - 1.0) < 0.05
    assert abs(ffn["w_out"].std().item() * 512 ** 0.5 - 1.0) < 0.05
    assert abs(f32.lm_head.std().item() * 256 ** 0.5 - 1.0) < 0.05
