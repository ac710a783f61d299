"""gemma3-27b in the port against the JAX package: sliding-window ring
caches, zero-centred and sandwich norms, the scaled embedding, the dense
engine.

At the f32 smoke config (window 8, 5 local + 1 global layers, then 1
local), with the reference's ``PRNGKey(0)`` weights carried across by
``models/convert.py`` and every norm scale perturbed (the reference draws
zero-centred scales as zeros: perturbed, ``1 + s`` and the post-norms are
really exercised):

  * ``gqa_forward`` on a local layer: a prefill of L ≤ W (output and ring
    rows against JAX's ring path, 1e-5) and a decode at per-slot positions
    past the ring's wrap (JAX run one slot at a time);
  * ``forward``, prefill then decode past the wrap, logits within 1e-4;
  * prompts past the window against the JAX **no-cache** forward (the
    port's prefill writes the last W keys once each; the reference's ring
    prefill collides there);
  * the dense engine against the JAX dense engine on equal-length mixes
    and single requests with prompts ≤ W, and against a greedy loop over
    the JAX no-cache forward on a ragged mix past W; a test pins that the
    JAX dense engine parts from its own no-cache forward at 12 tokens;
  * the paged, chunked, int8 and tp refusals in the reference's words;
  * the embedding scale in bf16 at d_model 5376, bit for bit with JAX;
  * the config, the full-width count (27,008,986,368) and the CLI.
"""
import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.kvcache import PagedCachePool as JPagedCachePool
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.kvcache import CachePool, token_bytes

ARCH = "gemma3-27b"
SRC = Path(__file__).resolve().parents[1] / "src"
NORMS = ("ln1", "ln2", "ln1_post", "ln2_post")
COUNTERS = ("decode_steps", "decode_tokens", "prefills", "admission_refusals",
            "token_fetches", "tokens_fetched")


@functools.lru_cache(maxsize=None)
def _w():
    """(jax cfg, jax params, numpy tree, port cfg): the smoke config in
    f32, every norm scale perturbed by N(0, 0.1²)."""
    cfg = jconfigs.get_smoke_config(ARCH, compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    tree = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(1)

    def perturb(leaf):
        leaf["scale"] = (leaf["scale"] + 0.1 * rng.standard_normal(
            leaf["scale"].shape)).astype(np.float32)

    for gp in tree["groups"]:
        for pos in gp:
            for name in NORMS:
                perturb(pos[name])
    perturb(tree["final_norm"])
    tcfg = tconfigs.get_smoke_config(ARCH, compute_dtype=torch.float32)
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), tree, tcfg


@functools.lru_cache(maxsize=None)
def _model():
    _, _, tree, tcfg = _w()
    return params_from_numpy(tree, tcfg)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _local_mixer():
    """The first local layer's attention weights (group 0, position 0)."""
    tree = _w()[2]
    return {k: v[0] for k, v in tree["groups"][0][0]["mixer"].items()}


# --------------------------------------------------------------------------
# the config, the weights, the embedding scale
# --------------------------------------------------------------------------
def test_config_is_the_references():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in ("name", "family", "d_model", "n_heads", "n_kv", "d_ff",
                  "vocab", "groups", "mlp", "qkv_bias", "rope_theta",
                  "window", "logit_softcap", "norm", "zero_centered_norm",
                  "sandwich_norm", "embed_scale", "tie_embeddings", "remat",
                  "q_chunk", "kv_chunk", "shard_kv_seq", "hd"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        for kind in ("local", "global"):
            assert t.window_of(kind) == j.attn_cfg(kind).window, (get, kind)
    full = tconfigs.get_config(ARCH)
    assert (full.n_layers(), full.d_model, full.n_heads, full.n_kv, full.hd,
            full.d_ff, full.vocab, full.window) == \
        (62, 5376, 32, 16, 128, 21504, 262144, 1024)
    kinds = [k for p, c in full.groups for _ in range(c) for k in p]
    assert kinds.count("local:mlp") == 52 and kinds.count("global:mlp") == 10


def test_full_width_counts_27b_on_meta():
    """The published widths on the ``meta`` device: 27,008,986,368
    parameters, as the reference's abstract shapes count (54.02 GB in bf16:
    one 80 GB card)."""
    cfg = tconfigs.get_config(ARCH, param_dtype=torch.bfloat16)
    model = ttransformer.init_model(cfg, None, "meta")
    n = ttransformer.count_params(model)
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(
            k, jconfigs.get_config(ARCH)))[0], jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes))
    assert n == 27_008_986_368


def test_ring_caches_and_the_reference_token_bytes():
    """Local layers hold rings of min(max_seq, window) rows, as the
    reference's ``_init_cache_one``; ``token_bytes`` stays the reference's
    (rings uncounted), and ``leaf_nbytes`` counts the real bytes: 4.83 GB
    for 8 slots of 2048 tokens at full width."""
    cfg, _, _, tcfg = _w()
    for S in (4, 8, 32):
        ref = jtransformer.init_caches(cfg, 2, S)
        got = ttransformer.init_caches(tcfg, 2, S)
        for jg, tg in zip(ref, got):
            for jl, tl in zip(jg, tg):
                for name in ("k", "v"):
                    assert tuple(tl[name].shape) == jl[name].shape, S
    full = tconfigs.get_config(ARCH)
    assert token_bytes(full) == 10 * 2 * 16 * 128 * 2
    ring = 2 * 8 * 16 * 1024 * 128 * 2
    glob = 2 * 8 * 16 * 2048 * 128 * 2
    assert (ring, glob) == (67_108_864, 134_217_728)
    assert 52 * ring + 10 * glob == 4_831_838_208
    pool = CachePool(tcfg, 3, 20)
    assert pool.leaf_nbytes() == 2 * 3 * 2 * 16 * 4 * (6 * 8 + 20)
    assert pool.footprint_bytes() == 3 * 20 * token_bytes(tcfg)


def test_convert_carries_the_post_norms_and_zero_centred_scales():
    _, _, tree, tcfg = _w()
    model = _model()
    for gi, gp in enumerate(tree["groups"]):
        for i, pos in enumerate(gp):
            stack = model.groups[gi][i]
            assert stack.post == ("ln1_post", "ln2_post")
            for name in NORMS:
                got = getattr(stack, name)
                np.testing.assert_array_equal(got.numpy(), pos[name]["scale"])
            unit = stack.unit(0)
            assert set(unit) == {"ln1", "mixer", "ln2", "ffn", "ln1_post",
                                 "ln2_post"}
    np.testing.assert_array_equal(model.final_norm.numpy(),
                                  tree["final_norm"]["scale"])
    assert model.head().data_ptr() == model.embed.data_ptr()   # tied


def test_init_draws_zero_centred_scales_and_the_post_norms():
    """The port's own init: zero-centred scales are zeros (the reference's
    ``_norm_init``), every layer carries ln1_post / ln2_post, and a config
    without sandwich norms carries none."""
    cfg = tconfigs.get_smoke_config(ARCH)
    model = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    assert not model.final_norm.any()
    for group in model.groups:
        for stack in group:
            for name in NORMS:
                assert not getattr(stack, name).any(), name
    qwen = ttransformer.init_model(tconfigs.get_smoke_config("qwen2-0.5b"),
                                   torch.Generator().manual_seed(0))
    assert qwen.groups[0][0].post == () and bool((qwen.final_norm == 1).all())
    ref = jtransformer.init_model(jax.random.PRNGKey(0),
                                  jconfigs.get_smoke_config(ARCH))
    ref = jblocks.split_params(ref)[0]
    assert set(ref["groups"][0][0]) == set(model.groups[0][0].unit(0))


def test_embed_scale_rounds_to_bf16_as_the_reference():
    """At d_model 5376 in bf16 the reference multiplies by √5376 rounded to
    bf16 (73.5); the port equals ``x * jnp.asarray(sqrt(5376),
    jnp.bfloat16)`` bit for bit. The Python-float product the port used
    before (√5376 = 73.32 unrounded) differs: 0.3 gives 22.0 against
    22.125."""
    d = 5376
    cfg = tconfigs.get_smoke_config(ARCH, d_model=d, d_ff=64, vocab=64,
                                    param_dtype=torch.bfloat16)
    model = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    table = rng.standard_normal((64, d)).astype(np.float32)
    table[0, 0] = 0.3
    ids = np.array([[0, 5, 17], [63, 0, 2]], np.int32)
    model.embed.data = torch.from_numpy(table).to(torch.bfloat16)
    got = ttransformer.embed(model, torch.from_numpy(ids))
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    ref = jblocks.embed_lookup(jt, jnp.asarray(ids)) * \
        jnp.asarray(math.sqrt(d), jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert ttransformer.embed_scale(d, torch.bfloat16) == 73.5
    ref_bits = np.asarray(ref).view(np.uint16)
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          ref_bits)
    assert got[0, 0, 0].item() == 22.125
    old = model.embed[torch.from_numpy(ids).long()] * math.sqrt(d)
    assert old[0, 0, 0].item() == 22.0
    assert not np.array_equal(old.view(torch.int16).numpy().view(np.uint16),
                              ref_bits)


def test_port_gemma3_config_leaves_jax_out():
    code = ("import sys\n"
            "import repro_torch\n"
            "from repro_torch import configs\n"
            "from repro_torch.models import transformer\n"
            "cfg = configs.get_config('gemma3-27b')\n"
            "transformer.init_model(cfg, None, 'meta')\n"
            "import repro_torch.serve.engine, repro_torch.launch.serve\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ISOLATED')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=SRC,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr


# --------------------------------------------------------------------------
# gqa_forward on a local layer, and forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("L", [5, 8])
def test_gqa_forward_local_prefill_matches_jax(L):
    """A prefill of L ≤ W = 8 tokens into a ring of 8 rows: the output and
    the ring rows against JAX's ring path."""
    cfg, _, _, tcfg = _w()
    rng = np.random.default_rng(3 + L)
    B, W, K, hd = 2, cfg.window, cfg.n_kv, cfg.hd
    m = _local_mixer()
    x = _rand(rng, B, L, cfg.d_model)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    jy, jc = jattention.gqa_forward(
        jax.tree_util.tree_map(jnp.asarray, m), jnp.asarray(x),
        jnp.asarray(pos), cfg.attn_cfg("local"),
        cache={"k": jnp.zeros((B, K, W, hd)), "v": jnp.zeros((B, K, W, hd))},
        cache_pos=jnp.zeros((), jnp.int32))
    cache = {"k": torch.zeros(B, K, W, hd), "v": torch.zeros(B, K, W, hd)}
    ty = tattention.gqa_forward(
        {k: torch.from_numpy(v) for k, v in m.items()}, torch.from_numpy(x),
        torch.from_numpy(pos.copy()), tcfg, cache, 0,
        window=tcfg.window_of("local"))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5)


def test_gqa_forward_ring_decode_at_per_slot_positions_matches_jax():
    """Slots at positions 3, 8, 13, 0 and 21 of a ring of 8 rows (three
    past the wrap): the port's one batched step against JAX's ring decode
    run one slot at a time at that slot's position."""
    cfg, _, _, tcfg = _w()
    rng = np.random.default_rng(7)
    W, K, hd = cfg.window, cfg.n_kv, cfg.hd
    positions = [3, 8, 13, 0, 21]
    B = len(positions)
    m = _local_mixer()
    x = _rand(rng, B, 1, cfg.d_model)
    kc, vc = _rand(rng, B, K, W, hd), _rand(rng, B, K, W, hd)
    cache = {"k": torch.from_numpy(kc.copy()),
             "v": torch.from_numpy(vc.copy())}
    pos_t = torch.tensor(positions, dtype=torch.int32)
    ty = tattention.gqa_forward(
        {k: torch.from_numpy(v) for k, v in m.items()}, torch.from_numpy(x),
        pos_t.long()[:, None], tcfg, cache, pos_t, window=cfg.window)
    jm = jax.tree_util.tree_map(jnp.asarray, m)
    for b, p in enumerate(positions):
        jy, jc = jattention.gqa_forward(
            jm, jnp.asarray(x[b:b + 1]), jnp.full((1, 1), p, jnp.int32),
            cfg.attn_cfg("local"),
            cache={"k": jnp.asarray(kc[b:b + 1]),
                   "v": jnp.asarray(vc[b:b + 1])},
            cache_pos=jnp.asarray(p, jnp.int32))
        np.testing.assert_allclose(ty[b:b + 1].numpy(), np.asarray(jy),
                                   atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name][b:b + 1].numpy(),
                                       np.asarray(jc[name]), atol=1e-5)


def test_gqa_forward_refuses_a_window_past_its_ring():
    _, _, _, tcfg = _w()
    m = {k: torch.from_numpy(v) for k, v in _local_mixer().items()}
    cache = {"k": torch.zeros(1, 2, 16, 16), "v": torch.zeros(1, 2, 16, 16)}
    with pytest.raises(ValueError, match="ring"):
        tattention.gqa_forward(m, torch.zeros(1, 2, tcfg.d_model),
                               torch.zeros(1, 2, dtype=torch.long), tcfg,
                               cache, 0, window=8)


def test_forward_prefill_then_decode_past_the_wrap_matches_jax():
    """Two slots prefill 6 tokens (≤ W), then four decode steps to position
    9 (the rings wrap at 8): logits within 1e-4 and every cache leaf
    within 1e-5 of JAX's."""
    cfg, params, _, tcfg = _w()
    model = _model()
    rng = np.random.default_rng(5)
    B, L, S = 2, 6, 16
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    jl, jc, _ = jtransformer.forward(
        params, jnp.asarray(toks), cfg,
        caches=jtransformer.init_caches(cfg, B, S),
        cache_pos=jnp.zeros((), jnp.int32), mode="prefill")
    caches = ttransformer.init_caches(tcfg, B, S)
    tl, _ = ttransformer.forward(model, torch.from_numpy(toks), caches, 0,
                                 "prefill")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for p in range(L, L + 4):
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc, _ = jtransformer.forward(
            params, jnp.asarray(nxt), cfg, caches=jc,
            cache_pos=jnp.asarray(p, jnp.int32), mode="decode")
        tl, _ = ttransformer.forward(model, torch.from_numpy(nxt), caches,
                                     torch.full((B,), p, dtype=torch.int32),
                                     "decode")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for jg, tg in zip(jc, caches):
        for jleaf, tleaf in zip(jg, tg):
            for name in ("k", "v"):
                np.testing.assert_allclose(tleaf[name].numpy(),
                                           np.asarray(jleaf[name]), atol=1e-5)


@functools.lru_cache(maxsize=None)
def _nocache_fn():
    cfg, params, _, _ = _w()
    fwd = jax.jit(lambda p, t: jtransformer.forward(p, t, cfg)[0])
    return functools.partial(fwd, params)


PAD = 32       # the no-cache forward runs every row padded to one length


def _nocache_logits(rows):
    """JAX's no-cache forward (``kpos > qpos - window`` by position) over
    token rows, each padded to ``PAD`` (causal: the padding changes no
    earlier position); returns [len(rows), PAD, vocab] numpy logits."""
    toks = np.zeros((len(rows), PAD), np.int32)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r
    return np.asarray(_nocache_fn()(jnp.asarray(toks)))


@pytest.mark.parametrize("L", [12, 20])
def test_forward_past_the_window_matches_the_jax_no_cache_forward(L):
    """A prompt of L > W tokens: the port's prefill logits, then three
    decode steps' logits, against the JAX no-cache forward over the same
    tokens, within 1e-4; the rings hold the last W keys, position p in row
    p % W, equal to the keys of a linear cache."""
    cfg, _, _, tcfg = _w()
    model = _model()
    rng = np.random.default_rng(L)
    W = cfg.window
    toks = rng.integers(0, cfg.vocab, (1, L)).astype(np.int32)
    caches = ttransformer.init_caches(tcfg, 1, 32)
    tl, _ = ttransformer.forward(model, torch.from_numpy(toks), caches, 0,
                                 "prefill")
    np.testing.assert_allclose(tl[0].numpy(), _nocache_logits(toks)[0, :L],
                               atol=1e-4)
    seq = list(toks[0])
    for p in range(L, L + 3):
        nxt = int(rng.integers(0, cfg.vocab))
        seq.append(nxt)
        tl, _ = ttransformer.forward(model, torch.tensor([[nxt]]), caches,
                                     torch.tensor([p], dtype=torch.int32),
                                     "decode")
        np.testing.assert_allclose(tl[0, 0].numpy(),
                                   _nocache_logits([seq])[0, p], atol=1e-4)
    # the first local layer's ring against the keys JAX writes into a
    # linear cache (S > window: the reference does not ring it)
    m = _local_mixer()
    x = ttransformer._norm_apply(
        model.groups[0][0].unit(0)["ln1"],
        ttransformer.embed(model, torch.tensor([seq])), tcfg).numpy()
    n = len(seq)
    _, jc = jattention.gqa_forward(
        jax.tree_util.tree_map(jnp.asarray, m), jnp.asarray(x),
        jnp.arange(n, dtype=jnp.int32)[None], cfg.attn_cfg("local"),
        cache={"k": jnp.zeros((1, cfg.n_kv, 32, cfg.hd)),
               "v": jnp.zeros((1, cfg.n_kv, 32, cfg.hd))},
        cache_pos=jnp.zeros((), jnp.int32))
    ring = caches[0][0]
    for name in ("k", "v"):
        lin = np.asarray(jc[name])[0]
        for p in range(n - W, n):
            np.testing.assert_allclose(ring[name][0, 0, :, p % W].numpy(),
                                       lin[:, p], atol=1e-5)


# --------------------------------------------------------------------------
# the dense engine
# --------------------------------------------------------------------------
def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, _w()[0].vocab, n).astype(np.int32) for n in lens]


def _serve(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        assert eng.submit(request_cls(seq_id=i, prompt=p.copy(),
                                      max_new=max_new))
    done = eng.run(max_steps=1000)
    assert eng.idle and len(done) == len(prompts)
    return {int(r.seq_id): list(r.tokens_out) for r in done}


def _counters(eng):
    s = eng.stats_summary()
    return {k: s[k] for k in COUNTERS}


def _jax(**kw):
    cfg, params, _, _ = _w()
    return JEngine(cfg, params, config=JEngineConfig(max_seq=64, **kw))


def _port(**kw):
    return TEngine(_w()[3], _model(), device="cpu",
                   config=TEngineConfig(max_seq=64, **kw))


EQUAL_MIXES = {            # (prompt lengths, seed, max_new, n_slots)
    "six": ((6, 6, 6, 6), 1, 5, 2),
    "five": ((5, 5, 5, 5, 5), 0, 4, 2),
    "window": ((8, 8, 8), 2, 6, 3),
}


@pytest.mark.parametrize("mix", sorted(EQUAL_MIXES))
def test_dense_engine_matches_jax_dense_engine_on_equal_lengths(mix):
    """Prompts ≤ W of one length (every slot at one position, where the
    reference's shared position is right), decode past the wrap: equal
    streams and counters."""
    lens, seed, max_new, n_slots = EQUAL_MIXES[mix]
    prompts = _prompts(lens, seed)
    jeng = _jax(n_slots=n_slots)
    ref = _serve(jeng, JRequest, prompts, max_new)
    eng = _port(n_slots=n_slots)
    assert _serve(eng, TRequest, prompts, max_new) == ref
    assert _counters(eng) == _counters(jeng)
    assert isinstance(eng.pool, CachePool) and not eng.config.cache.paged
    assert (eng.pool.seq_ids < 0).all() and not eng.pool.lengths.any()


@pytest.mark.parametrize("n", [3, 5, 8])
def test_dense_engine_matches_jax_dense_engine_on_single_requests(n):
    prompt = _prompts((n,), 10 + n)
    ref = _serve(_jax(n_slots=2), JRequest, prompt, 7)
    assert _serve(_port(n_slots=2), TRequest, prompt, 7) == ref


RAGGED = (3, 9, 5, 12, 20)          # prompt lengths, default_rng(1)


def _nocache_greedy(prompts, max_new):
    """Greedy streams from JAX's no-cache forward, every prompt at once."""
    rows = [list(p) for p in prompts]
    out = [[] for _ in prompts]
    for _ in range(max_new):
        logits = _nocache_logits(rows)
        for i, r in enumerate(rows):
            tok = int(np.argmax(logits[i, len(r) - 1]))
            out[i].append(tok)
            r.append(tok)
    return dict(enumerate(out))


def test_dense_engine_matches_the_jax_no_cache_forward_past_the_window():
    """Prompts of 3, 9, 5, 12 and 20 tokens (three past W = 8) over four
    slots, six new tokens: the port's dense engine gives the greedy streams
    of the JAX no-cache forward. The fifth request takes a freed slot whose
    ring rows still hold its last tenant's keys."""
    prompts = _prompts(RAGGED, 1)
    eng = _port(n_slots=4)
    assert _serve(eng, TRequest, prompts, 6) == _nocache_greedy(prompts, 6)
    assert eng.stats["prefills"] == 5 and (eng.pool.seq_ids < 0).all()


def test_the_reference_dense_engine_parts_from_its_forward_past_the_window():
    """The reference's ring prefill scatters L > W keys into W rows with
    colliding indices and then attends the ring as if row i held position
    i (``repro/models/attention.py`` ``_ring_update``): a 12-token prompt
    alone in its dense engine gives other tokens than its own no-cache
    forward from the first token on; at 5 and 8 tokens (≤ W, decode past
    the wrap) the two agree, and so does the port at all three."""
    for n, agree in ((5, True), (8, True), (12, False)):
        prompt = _prompts((n,), 20 + n)
        ref = _nocache_greedy(prompt, 6)
        dense = _serve(_jax(n_slots=1), JRequest, prompt, 6)
        assert (dense == ref) == agree, (n, dense, ref)
        if not agree:
            assert dense[0][0] != ref[0][0], (dense, ref)
        assert _serve(_port(n_slots=1), TRequest, prompt, 6) == ref


STACKS = {     # EngineConfig kwargs; each needs a page pool
    "paged": dict(cache=dict(paged=True)),
    "chunked": dict(chunked=True),
    "int8": dict(cache=dict(paged=True, kv_dtype="int8")),
    "tiered": dict(cache=dict(tiered=True)),
    "prefix": dict(cache=dict(prefix=True)),
    "tp": dict(tp=2),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_paged_stacks_refuse_gemma3_in_the_reference_words(stack):
    """The local layers are not pageable: every stack that needs a page
    pool refuses gemma3 as the reference's pool does, the port's before it
    builds anything (under tp, before the executor asks for its ranks)."""
    cfg, params, _, tcfg = _w()
    with pytest.raises(ValueError) as ref:
        JPagedCachePool(cfg, max_batch=2, max_seq=64, n_pages=8)
    kw = dict(STACKS[stack])
    cache = kw.pop("cache", {})
    if stack != "tp":      # the reference's tp path needs devices first
        with pytest.raises(ValueError) as jexc:
            JEngine(cfg, params, config=JEngineConfig(
                n_slots=2, max_seq=64, cache=JCacheConfig(**cache), **kw))
        assert str(jexc.value) == str(ref.value)
    with pytest.raises(ValueError) as got:
        TEngine(tcfg, _model(), device="cpu", config=TEngineConfig(
            n_slots=2, max_seq=64, cache=TCacheConfig(**cache), **kw))
    assert str(got.value) == str(ref.value)
    assert "mixer 'local' is not pageable" in str(got.value)


def test_serve_cli_gemma3_on_the_cpu(capsys):
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
              "--slots", "2", "--max-seq", "32", "--max-new", "3",
              "--prompt-len", "5", "--prompt-len-max", "12"]
    serve.main(common)
    out = capsys.readouterr().out
    assert "[serve:dense] 3 requests, 9 tokens" in out
    leaves = CachePool(_w()[3], 2, 32).leaf_nbytes() // 2   # f32 -> bf16
    assert f"B estimated, {leaves} B of leaves)" in out
    for flag in (["--chunked-prefill"], ["--paged"], ["--kv-dtype", "int8"]):
        with pytest.raises(ValueError, match="not pageable"):
            serve.main(common + flag)
