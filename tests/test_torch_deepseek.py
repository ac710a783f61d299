"""deepseek-v3-671b in the port against the JAX package: MLA layers, the
sigmoid-routed MoE with a shared expert, the MTP head's leaves, the dense
engine.

At the reference's f32 smoke config (1 dense + 2 MoE layers; d_model 64,
4 heads, q_lora 32, kv_lora 16, 8 experts top-2, 1 shared) with its
``PRNGKey(0)`` weights carried across by ``models/convert.py`` (every
norm scale, ``q_norm`` and ``kv_norm`` perturbed for the forward and step
tests):

  * the config field for field; the parameter counts on ``meta`` equal to
    ``jax.eval_shape``'s, for the full config (682,636,457,984, MTP
    included) and for the card's depth cut (3 dense + 2 MoE layers at full
    width, MTP undrawn: 26,618,387,456); ``token_bytes`` and the cut's
    8 x 2048 pool (94,371,840 B);
  * ``forward`` and train/step.py's steps against JAX's, logits within
    1e-4;
  * the dense engine against the JAX dense engine on equal prompt lengths
    at the default capacity factor (the reference decodes every slot at
    one shared position, ROADMAP.md §3), and against a greedy loop over
    the JAX no-cache forward on ragged and slot-reuse mixes. Capacity
    couples the rows of a call and that loop batches other rows than the
    engine does, so those mixes run at ``capacity_factor = n_experts /
    top_k`` on both sides, where no expert can drop a token, and 0 drops
    are asserted; the reference's shared decode position, pinned;
  * the paged engines, the chunked engine and tp refusing the arch in the
    reference's words before any weight is drawn, and the CLI on the CPU.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.kvcache import PagedCachePool as JPagedCachePool
from repro.serve.kvcache import token_bytes as jtoken_bytes
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.kvcache import CachePool, token_bytes
from repro_torch.train import step as tstep

ARCH = "deepseek-v3-671b"
SRC = Path(__file__).resolve().parents[1] / "src"
CUT = dict(groups=((("mla:mlp",), 3), (("mla:moe",), 2)), mtp=False)
NO_DROPS = 8 / 2          # the smoke config's n_experts / top_k
PERTURBED = ("scale", "q_norm", "kv_norm")      # init: ones
COUNTERS = ("decode_steps", "decode_tokens", "prefills", "admission_refusals",
            "token_fetches", "tokens_fetched")


def close(got, ref, rtol=1e-4, atol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _with_cf(cfg, cf):
    if cf is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@functools.lru_cache(maxsize=None)
def weights(perturb=False, cf=None):
    """(jax cfg, jax params, numpy tree, port cfg): the smoke config in f32
    from ``PRNGKey(0)`` at capacity factor ``cf`` (None: the config's);
    with ``perturb``, every norm scale moved by N(0, 0.1²)."""
    cfg = _with_cf(jconfigs.get_smoke_config(ARCH, compute_dtype=jnp.float32),
                   cf)
    tree = jax.tree_util.tree_map(np.array, jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0])
    if perturb:
        rng = np.random.default_rng(1)

        def walk(node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v)
                elif k in PERTURBED:
                    node[k] = (v + 0.1 * rng.standard_normal(v.shape)
                               ).astype(np.float32)

        for gp in tree["groups"]:
            for pos in gp:
                walk(pos)
        walk(tree["final_norm"])
        walk(tree["mtp"])
    tcfg = _with_cf(tconfigs.get_smoke_config(ARCH,
                                              compute_dtype=torch.float32), cf)
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), tree, tcfg


@functools.lru_cache(maxsize=None)
def model(perturb=False, cf=None):
    tree, tcfg = weights(perturb, cf)[2:]
    return params_from_numpy(tree, tcfg)


def prompts_of(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def serve(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        assert eng.submit(request_cls(seq_id=i, prompt=p.copy(),
                                      max_new=max_new))
    done = eng.run(max_steps=1000)
    assert eng.idle and len(done) == len(prompts)
    return {int(r.seq_id): list(r.tokens_out) for r in done}


def counters(eng):
    s = eng.stats_summary()
    return {k: s[k] for k in COUNTERS}


def jax_dense(prompts, max_new, n_slots, max_seq=64, cf=None):
    cfg, params = weights(cf=cf)[:2]
    eng = JEngine(cfg, params, config=JEngineConfig(n_slots=n_slots,
                                                    max_seq=max_seq))
    return serve(eng, JRequest, prompts, max_new), counters(eng)


def port_dense(prompts, max_new, n_slots, max_seq=64, cf=None):
    eng = TEngine(weights(cf=cf)[3], model(cf=cf), device="cpu",
                  config=TEngineConfig(n_slots=n_slots, max_seq=max_seq))
    streams = serve(eng, TRequest, prompts, max_new)
    assert (eng.pool.seq_ids < 0).all() and not eng.pool.lengths.any()
    return streams, counters(eng)


@functools.lru_cache(maxsize=None)
def jax_prefill(cfg):
    return jax.jit(jstep.make_prefill_step(cfg))


@functools.lru_cache(maxsize=None)
def jax_decode(cfg):
    return jax.jit(jstep.make_decode_step(cfg))


NOCACHE_ROWS, NOCACHE_LEN = 8, 80   # every no-cache call at one shape


@functools.lru_cache(maxsize=None)
def _nocache_fn(cf):
    cfg, params = weights(cf=cf)[:2]
    fwd = jax.jit(lambda p, t: jtransformer.forward(p, t, cfg)[0])
    return functools.partial(fwd, params)


def nocache_greedy(prompts, max_new, cf=NO_DROPS):
    """Greedy streams from JAX's no-cache forward (MLA expanded, every
    layer causal; at ``cf`` = E / top_k no token is dropped, so a padded
    row changes no other row)."""
    rows = [list(p) for p in prompts]
    out = [[] for _ in prompts]
    assert len(rows) <= NOCACHE_ROWS
    for _ in range(max_new):
        toks = np.zeros((NOCACHE_ROWS, NOCACHE_LEN), np.int32)
        for i, r in enumerate(rows):
            toks[i, :len(r)] = r
        logits = np.asarray(_nocache_fn(cf)(jnp.asarray(toks)))
        for i, r in enumerate(rows):
            tok = int(np.argmax(logits[i, len(r) - 1]))
            out[i].append(tok)
            r.append(tok)
    return dict(enumerate(out))


# --------------------------------------------------------------------------
# config, counts, caches, weights
# --------------------------------------------------------------------------
def test_config_is_the_references():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in dataclasses.fields(j):
            if f.name in ("param_dtype", "compute_dtype", "mla", "moe"):
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (get, f.name)
        assert dataclasses.asdict(t.mla) == dataclasses.asdict(j.mla)
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
        assert str(t.param_dtype)[6:] == str(np.dtype(j.param_dtype))
        assert t.compute_dtype is torch.bfloat16
    full = tconfigs.get_config(ARCH)
    kinds = Counter(k for p, c in full.groups for _ in range(c) for k in p)
    assert kinds == {"mla:mlp": 3, "mla:moe": 58} and full.mtp
    assert (full.d_model, full.n_heads, full.d_ff, full.vocab,
            full.moe.n_experts, full.moe.top_k, full.moe.d_ff,
            full.moe.router, full.tie_embeddings) == \
        (7168, 128, 18432, 129280, 256, 8, 2048, "sigmoid", False)


@pytest.mark.parametrize("cut,count", [
    (False, 682_636_457_984), (True, 26_618_387_456)],
    ids=["full", "cut 3 dense + 2 moe, no mtp"])
def test_count_on_meta_equals_the_references(cut, count):
    """The full config draws 682,636,457,984 parameters (11,610,053,632 of
    them the MTP head); the card's cut, every layer at full width, 3 dense
    + 2 MoE layers and no MTP, 26,618,387,456: each what the reference's
    abstract shapes count."""
    over = CUT if cut else {}
    model = ttransformer.init_model(
        tconfigs.get_config(ARCH, param_dtype=torch.bfloat16, **over), None,
        "meta")
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(
            k, dataclasses.replace(jconfigs.get_config(ARCH), **over)))[0],
        jax.random.PRNGKey(0))
    n = ttransformer.count_params(model)
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes)) == count
    assert (model.mtp is None) == cut


def test_token_bytes_and_the_cut_pool():
    """``token_bytes`` is the reference's: (512 + 64) x 2 B a token and
    layer, 70,272 B for 61 layers, 5,760 B for the cut's 5; the cut's 8 x
    2048 pool holds exactly that, 94,371,840 B of latents."""
    full = tconfigs.get_config(ARCH)
    cut = tconfigs.get_config(ARCH, param_dtype=torch.bfloat16, **CUT)
    assert token_bytes(full) == jtoken_bytes(jconfigs.get_config(ARCH)) == \
        61 * 576 * 2 == 70_272
    assert token_bytes(cut) == jtoken_bytes(dataclasses.replace(
        jconfigs.get_config(ARCH), **CUT)) == 5_760
    pool = CachePool(cut, 8, 2048, device="meta")
    assert pool.leaf_nbytes() == pool.footprint_bytes() == \
        8 * 2048 * 5 * 576 * 2 == 94_371_840


def test_caches_are_the_references():
    cfg, _, _, tcfg = weights()
    ref = jax.eval_shape(lambda: jtransformer.init_caches(cfg, 3, 16))
    got = ttransformer.init_caches(tcfg, 3, 16)
    for jg, tg in zip(ref, got):
        for jl, tl in zip(jg, tg):
            assert set(jl) == set(tl) == {"ckv", "kr"}
            for name in jl:
                assert tuple(tl[name].shape) == jl[name].shape, name
                assert str(tl[name].dtype)[6:] == str(jl[name].dtype), name
    assert [ttransformer.cache_seq_axis(m) for m in ("mla", "gqa", "mamba")] \
        == [2, 3, None]


def test_convert_carries_the_mla_leaves_and_the_mtp_head():
    """Every MLA leaf lands leaf for leaf, and the MTP head (``proj``, an
    unstacked ``mla:moe`` block with its shared expert, ``norm``) beside
    the groups; the port's count is the tree's."""
    tree = weights(True)[2]
    m = model(True)
    mixer = m.groups[1][0].mixer
    assert set(mixer) == set(tree["groups"][1][0]["mixer"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk", "w_uv",
        "wo"}
    for name, leaf in tree["groups"][1][0]["mixer"].items():
        np.testing.assert_array_equal(mixer[name].numpy(), leaf)
    mtp = tree["mtp"]
    np.testing.assert_array_equal(m.mtp.proj.numpy(), mtp["proj"])
    np.testing.assert_array_equal(m.mtp.norm.numpy(), mtp["norm"]["scale"])
    block = m.mtp.block
    for name, leaf in mtp["block"]["mixer"].items():
        np.testing.assert_array_equal(block.mixer[name].numpy(), leaf)
    np.testing.assert_array_equal(block.ffn_shared["w_up"].numpy(),
                                  mtp["block"]["ffn"]["shared"]["w_up"])
    np.testing.assert_array_equal(block.ffn["router"].numpy(),
                                  mtp["block"]["ffn"]["router"])
    assert sum(a.size for a in jax.tree_util.tree_leaves(tree)) == \
        ttransformer.count_params(m)


def test_init_draws_the_reference_tree():
    """The port's own init: the reference's leaves, shape for shape (the
    MTP head with them), MLA's norm scales ones, the MoE router f32."""
    cfg = tconfigs.get_smoke_config(ARCH)
    m = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    ref = jblocks.split_params(jtransformer.init_model(
        jax.random.PRNGKey(0), jconfigs.get_smoke_config(ARCH)))[0]
    assert Counter(tuple(p.shape) for p in m.parameters()) == Counter(
        a.shape for a in jax.tree_util.tree_leaves(ref))
    assert tuple(m.mtp.proj.shape) == ref["mtp"]["proj"].shape == (128, 64)
    mixer = m.groups[0][0].mixer
    assert torch.equal(mixer["q_norm"], torch.ones_like(mixer["q_norm"]))
    assert m.groups[1][0].ffn["router"].dtype == torch.float32
    assert m.mtp.block.ffn["router"].dtype == torch.float32


def test_large_leaves_are_drawn_in_pieces(monkeypatch):
    """A slice of a stacked leaf past ``DRAW_ELEMS`` (one layer of the full
    config's experts, [256, 7168, 2048], is 3.8e9) is split again: every
    piece within the cap, the pieces tiling the leaf once; a slice within
    it stays whole, as before."""
    monkeypatch.setattr(ttransformer, "DRAW_ELEMS", 64)
    t = torch.zeros(2, 3, 8, 16)
    pieces = ttransformer._pieces(t)
    assert all(p.numel() <= 64 for p in pieces)
    for p in pieces:
        p += 1
    assert torch.equal(t, torch.ones_like(t))
    assert [tuple(p.shape) for p in ttransformer._pieces(
        torch.zeros(2, 4, 8))] == [(4, 8), (4, 8)]
    w = ttransformer._normal((2, 3, 8, 16), 1.0,
                             torch.Generator().manual_seed(0), "cpu",
                             torch.float32)
    assert torch.isfinite(w).all() and 0.8 < w.std().item() < 1.2


def test_modules_import_without_jax():
    code = ("import sys\n"
            "import repro_torch.models.attention\n"
            "from repro_torch import configs\n"
            "from repro_torch.models import transformer\n"
            "transformer.init_model(configs.get_config("
            f"'{ARCH}'), None, 'meta')\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ISOLATED')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=SRC,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr


# --------------------------------------------------------------------------
# forward and steps
# --------------------------------------------------------------------------
def test_forward_prefill_then_decode_matches_jax():
    """Two slots prefill 13 tokens, then 3 decode steps: logits within
    1e-4, every latent cache leaf within 1e-4 of JAX's."""
    cfg, params, _, tcfg = weights(True)
    m = model(True)
    rng = np.random.default_rng(5)
    B, L, S = 2, 13, 32
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    jl, jc = jax_prefill(cfg)(params, jnp.asarray(toks),
                              jtransformer.init_caches(cfg, B, S))
    caches = ttransformer.init_caches(tcfg, B, S)
    tl, _ = ttransformer.forward(m, torch.from_numpy(toks), caches, 0,
                                 "prefill")
    close(tl[:, -1], jl[:, -1])
    for p in range(L, L + 3):
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jax_decode(cfg)(params, jnp.asarray(nxt), jc,
                                 jnp.asarray(p, jnp.int32))
        tl, _ = ttransformer.forward(m, torch.from_numpy(nxt), caches,
                                     torch.full((B,), p, dtype=torch.int32),
                                     "decode")
        close(tl[:, -1], jl[:, -1])
    for jg, tg in zip(jc, caches):
        for jleaf, tleaf in zip(jg, tg):
            for name in jleaf:
                close(tleaf[name], jleaf[name])


def test_steps_match_the_jax_steps():
    """train/step.py's prefill and 6 decode steps against the reference's
    steps: logits within 1e-4 at every step, the same greedy tokens."""
    cfg, params, _, tcfg = weights(True)
    m = model(True)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12))
    tpre, tdec = tstep.make_prefill_step(tcfg), tstep.make_decode_step(tcfg)
    jl, jc = jax_prefill(cfg)(params, jnp.asarray(toks, jnp.int32),
                              jtransformer.init_caches(cfg, 2, 32))
    tl, tc = tpre(m, torch.from_numpy(toks),
                  ttransformer.init_caches(tcfg, 2, 32))
    for pos in range(12, 18):
        close(tl, jl)
        nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        assert (tl[:, -1].argmax(-1).numpy()[:, None] == nxt).all()
        jl, jc = jax_decode(cfg)(params, jnp.asarray(nxt, jnp.int32), jc,
                                 jnp.asarray(pos, jnp.int32))
        tl, tc = tdec(m, torch.from_numpy(nxt), tc, pos)
    close(tl, jl)


def test_mla_calls_no_attention_kernel(monkeypatch):
    """MLA runs plain PyTorch (the reference's is plain jnp): a prefill and
    its decode steps call neither dense attention kernel, and
    ``attention_calls`` lists none for the full config."""
    _, _, _, tcfg = weights()
    seen = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: seen.append("flash_attention"))
    monkeypatch.setattr(tda, "flash_decode",
                        lambda *a, **k: seen.append("flash_decode"))
    toks = torch.from_numpy(prompts_of((9,), 3)[0])[None]
    logits, caches = tstep.make_prefill_step(tcfg)(
        model(), toks, ttransformer.init_caches(tcfg, 1, 16))
    tstep.make_decode_step(tcfg)(model(), logits[:, -1].argmax(-1)[:, None],
                                 caches, 9)
    assert seen == []
    assert tstep.attention_calls(tconfigs.get_config(ARCH), 8, 1326, 2048,
                                 64) == []


# --------------------------------------------------------------------------
# the dense engine
# --------------------------------------------------------------------------
EQUAL = {             # (prompt lengths, seed, n_slots)
    "fresh slots": ((7, 7, 7), 2, 4),
    "reused slots": ((6, 6, 6, 6), 11, 2),
}


@pytest.mark.parametrize("mix", sorted(EQUAL))
def test_dense_engine_matches_jax_dense_engine_on_equal_lengths(mix):
    """Equal prompt lengths, every resident slot at one position, where the
    reference's shared decode position is right; the default capacity
    factor, so the coupled prefill's rows (every slot's, the others token
    0) compete for experts as in the reference. The same streams and
    counters."""
    lens, seed, n_slots = EQUAL[mix]
    prompts = prompts_of(lens, seed)
    assert port_dense(prompts, 5, n_slots) == jax_dense(prompts, 5, n_slots)


MIXES = {            # (prompt lengths, seed, n_slots, max_seq)
    "ragged": ((3, 9, 5, 12, 20), 1, 4, 64),
    "slot reuse": ((40, 70, 35, 66, 33, 50), 1, 2, 96),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_dense_engine_matches_the_jax_no_cache_forward(mix, monkeypatch):
    """Ragged prompts (each slot's latents at its own position) and more
    requests than slots (later requests in reused slots, over the latents
    of earlier ones): the port's dense engine gives the greedy streams of
    the JAX no-cache forward, with no expert dropping a token."""
    lens, seed, n_slots, max_seq = MIXES[mix]
    prompts = prompts_of(lens, seed)
    inner, drops = tmoe.dispatch_compute, []

    def counting(xf, router_w, *rest):
        c = rest[-1]
        gates, idx, _ = tmoe.route(router_w, xf, c)
        sel = tmoe.select(gates, idx, c)
        drops.append(int(tmoe.dropped(idx, *sel[1:], c.n_experts)))
        return inner(xf, router_w, *rest)

    monkeypatch.setattr(tmoe, "dispatch_compute", counting)
    streams, count = port_dense(prompts, 6, n_slots, max_seq, cf=NO_DROPS)
    assert streams == nocache_greedy(prompts, 6)
    assert count["prefills"] == len(lens)
    assert len(drops) > 0 and sum(drops) == 0


def test_the_reference_dense_engine_decodes_mla_at_one_shared_position():
    """The reference's cached MLA takes one scalar position, the largest
    length less one (``repro/serve/scheduler.py:463-469``): on the ragged
    mix its dense engine parts from its own no-cache forward on requests
    0-2, the first four's shorter three (request 3, the longest, and
    request 4, admitted alone after them, agree), where the port's does
    not."""
    lens, seed, n_slots, _ = MIXES["ragged"]
    prompts = prompts_of(lens, seed)
    ref = nocache_greedy(prompts, 6)
    dense = jax_dense(prompts, 6, n_slots, cf=NO_DROPS)[0]
    assert [i for i in ref if dense[i] != ref[i]] == [0, 1, 2]
    assert port_dense(prompts, 6, n_slots, cf=NO_DROPS)[0] == ref


STACKS = {     # EngineConfig kwargs; each needs a page pool
    "paged": dict(cache=dict(paged=True)),
    "chunked": dict(chunked=True),
    "int8": dict(cache=dict(paged=True, kv_dtype="int8")),
    "tiered": dict(cache=dict(tiered=True)),
    "prefix": dict(cache=dict(prefix=True)),
    "tp": dict(tp=2),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_paged_stacks_refuse_deepseek_in_the_reference_words(stack):
    cfg, _, _, tcfg = weights()
    with pytest.raises(ValueError) as ref:
        JPagedCachePool(cfg, max_batch=2, max_seq=64, n_pages=8)
    kw = dict(STACKS[stack])
    cache = kw.pop("cache", {})
    with pytest.raises(ValueError) as got:
        TEngine(tcfg, model(), device="cpu", config=TEngineConfig(
            n_slots=2, max_seq=64, cache=TCacheConfig(**cache), **kw))
    assert str(got.value) == str(ref.value)
    assert "mixer 'mla' is not pageable" in str(got.value)


def test_serve_cli_deepseek_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
              "--slots", "2", "--max-seq", "48", "--max-new", "3",
              "--prompt-len", "5", "--prompt-len-max", "40"]
    serve.main(common)
    out = capsys.readouterr().out
    assert "[serve:dense] 3 requests, 9 tokens" in out
    pool = CachePool(tconfigs.get_smoke_config(ARCH), 2, 48)
    assert pool.leaf_nbytes() == pool.footprint_bytes() == 2 * 48 * 3 * 24 * 2
    assert f"({pool.footprint_bytes()} B estimated, {pool.leaf_nbytes()} " \
        "B of leaves)" in out
    drawn = []
    monkeypatch.setattr(ttransformer, "init_model",
                        lambda *a, **k: drawn.append(a))
    for flag in (["--chunked-prefill"], ["--paged"], ["--kv-dtype", "int8"],
                 ["--tp", "2"]):
        with pytest.raises(ValueError, match="'mla' is not pageable"):
            serve.main(common + flag)
    assert drawn == []
