"""The port's MoE (models/moe.py) and granite-moe-3b-a800m's model against
the JAX package.

``moe_forward`` against the reference's meshless ``moe.moe_forward`` (the
path serving takes: no mesh is set) on the reference's ``PRNGKey(0)``
``init_moe`` leaves, at f32: y within 1e-5 of its largest magnitude (the
outputs reach ~40), aux within 1e-6, on granite's smoke ``MoeConfig``, on
a sigmoid router with a shared expert, where capacity binds, and where
equal gates straddle an expert's capacity boundary (duplicated token
rows: the port must drop the tokens JAX drops). ``capacity`` equals the
reference's; the granite tree has the reference's leaf shapes and dtypes
and its parameter count at full width (on ``meta``); ``transformer.
forward`` of the smoke model equals JAX's logits within 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_numpy

ARCH = "granite-moe-3b-a800m"
SMOKE = jconfigs.get_smoke_config(ARCH).moe
MOE_CFGS = {"granite": SMOKE,
            "sigmoid+shared": dataclasses.replace(SMOKE, router="sigmoid",
                                                  n_shared=1)}


@functools.lru_cache(maxsize=None)
def _moe_params(name):
    cfg = MOE_CFGS[name]
    p = jblocks.split_params(jmoe.init_moe(jax.random.PRNGKey(0), cfg))[0]
    return cfg, p, jax.tree_util.tree_map(np.array, p)


def _both(name, x):
    """(JAX y, aux), (port y, aux) and the port's drop count on ``x``."""
    cfg, jp, tree = _moe_params(name)
    jy, ja = jmoe.moe_forward(jp, jnp.asarray(x), cfg)
    tp = jax.tree_util.tree_map(torch.from_numpy, tree)
    ty, ta = tmoe.moe_forward(tp, torch.from_numpy(x), cfg)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    gates, idx, _ = tmoe.route(tp["router"], xf, cfg)
    sel = tmoe.select(gates, idx, cfg)
    drops = int(tmoe.dropped(idx, *sel[1:], cfg.n_experts))
    return (np.asarray(jy), float(ja)), (ty.numpy(), float(ta)), drops


def _close(ref, got):
    """y within 1e-5 of the reference's scale (max |y|: f32 products of
    N(0, 1/E) experts reach ~40, and their rounding alone is ~1e-5
    absolute); a term dropped differently moves a row by ~1-10."""
    err = np.abs(got[0] - ref[0]).max()
    assert err <= 1e-5 * max(1.0, np.abs(ref[0]).max()), err
    assert abs(got[1] - ref[1]) <= 1e-6


@pytest.mark.parametrize("name", sorted(MOE_CFGS))
@pytest.mark.parametrize("shape", [(2, 9), (1, 1), (3, 4)])
def test_moe_forward_matches_jax(name, shape):
    x = np.random.default_rng(5).standard_normal(
        shape + (SMOKE.d_model,)).astype(np.float32)
    ref, got, _ = _both(name, x)
    _close(ref, got)


@pytest.mark.parametrize("name", sorted(MOE_CFGS))
def test_moe_forward_matches_jax_where_capacity_binds(name):
    """256 tokens: C 80 of an even share of 64, and the port's routing
    drops assignments; the same terms go as in JAX."""
    x = np.random.default_rng(5).standard_normal(
        (1, 256, SMOKE.d_model)).astype(np.float32)
    ref, got, drops = _both(name, x)
    assert drops > 0
    _close(ref, got)


def _jax_kept(name, x):
    """The reference's own selection (its ``_dispatch_compute`` steps up
    to the per-expert top-C): the (token, expert) pairs it keeps."""
    cfg, jp, _ = _moe_params(name)
    xf = jnp.asarray(x.reshape(-1, cfg.d_model))
    N = xf.shape[0]
    gates, idx, _ = jmoe.route(jp["router"], xf, cfg)
    C = jmoe.capacity(N, cfg)
    gm = jnp.zeros((max(N, C), cfg.n_experts), jnp.float32).at[
        jnp.arange(N)[:, None], idx].set(gates.astype(jnp.float32))
    sg, st = jax.lax.top_k(gm.T, C)
    return {(int(t), e) for e in range(cfg.n_experts)
            for g, t in zip(np.asarray(sg[e]), np.asarray(st[e])) if g > 0}


def _port_kept(name, x):
    cfg, _, tree = _moe_params(name)
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    gates, idx, _ = tmoe.route(torch.from_numpy(tree["router"]), xf, cfg)
    sg, st, sv = tmoe.select(gates, idx, cfg)
    return {(int(t), e) for e in range(cfg.n_experts)
            for t, v in zip(st[e].tolist(), sv[e].tolist()) if v}


@pytest.mark.parametrize("name", sorted(MOE_CFGS))
def test_ties_at_the_capacity_boundary_drop_what_jax_drops(name):
    """Twelve copies of one token among four others: the copies' gates are
    equal, so each of their experts sees more equal gates than it has room
    for. JAX keeps the lowest token indices; so must the port (the copies'
    outputs then differ, and each matches JAX's)."""
    rng = np.random.default_rng(9)
    rows = rng.standard_normal((5, SMOKE.d_model)).astype(np.float32)
    x = np.concatenate([rows[:2], np.repeat(rows[2:3], 12, 0),
                        rows[3:]])[None]                       # [1, 16, d]
    kept = _jax_kept(name, x)
    assert _port_kept(name, x) == kept
    copies = range(2, 14)
    ref, got, drops = _both(name, x)
    assert drops > 0
    dropped_copies = [t for t in copies
                      if len({e for tt, e in kept if tt == t}) < SMOKE.top_k]
    assert 0 < len(dropped_copies) < len(copies)     # the boundary splits them
    assert not np.allclose(got[0][0, copies[0]], got[0][0, copies[-1]])
    _close(ref, got)


def test_combine_is_the_reference_scatter_add():
    """The gather combine equals a scatter-add of the gated expert outputs
    in (expert, slot) order, bit for bit at f32 and bf16."""
    cfg = MOE_CFGS["granite"]
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        xf = torch.randn(40, cfg.d_model, generator=g)
        gates, idx, _ = tmoe.route(torch.randn(cfg.d_model, cfg.n_experts,
                                               generator=g), xf.to(dt), cfg)
        sg, st, sv = tmoe.select(gates, idx, cfg)
        ye = torch.randn(cfg.n_experts, st.shape[1], cfg.d_model,
                         generator=g).to(dt) * sg[..., None].to(dt)
        want = torch.zeros(40, cfg.d_model, dtype=dt)
        for e in range(cfg.n_experts):
            for c in range(st.shape[1]):
                want[st[e, c]] += ye[e, c]
        got = tmoe._combine(ye, idx, st, sv)
        assert torch.equal(got, want), dt


def test_capacity_is_the_reference():
    for cfg in (SMOKE, jconfigs.get_config(ARCH).moe):
        for n in (1, 4, 8, 16, 256, 10608):
            assert tmoe.capacity(n, cfg) == jmoe.capacity(n, cfg), (cfg, n)
    assert tmoe.capacity(16, jconfigs.get_config(ARCH).moe) == 8   # decode


def test_configs_are_the_references():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in ("name", "family", "d_model", "n_heads", "n_kv", "d_ff",
                  "vocab", "groups", "mlp", "qkv_bias", "rope_theta",
                  "tie_embeddings", "norm", "window", "hd"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    full = tconfigs.get_config(ARCH)
    assert (full.n_layers(), full.d_model, full.n_heads, full.n_kv, full.hd,
            full.vocab, full.moe.n_experts, full.moe.top_k,
            full.moe.d_ff) == (32, 1536, 24, 8, 64, 49155, 40, 8, 512)


# --------------------------------------------------------------------------
# the granite model: tree, counts, init, forward
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _weights():
    cfg = jconfigs.get_smoke_config(ARCH, compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    tcfg = tconfigs.get_smoke_config(ARCH, compute_dtype=torch.float32)
    return cfg, params, jax.tree_util.tree_map(np.array, params), tcfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _port_tree(model):
    """The port's module as the reference tree: name → (shape, dtype)."""
    out = {"embed": model.embed, "final_norm.scale": model.final_norm}
    for gi, group in enumerate(model.groups):
        for pi, stack in enumerate(group):
            unit = {"ln1": {"scale": stack.ln1}, "ln2": {"scale": stack.ln2},
                    "mixer": dict(stack.mixer), "ffn": dict(stack.ffn)}
            if stack.ffn_shared is not None:
                unit["ffn"]["shared"] = dict(stack.ffn_shared)
            out.update(_flat(unit, f"groups.{gi}.{pi}."))
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in out.items()}


@pytest.mark.parametrize("shared", [0, 1])
def test_init_tree_is_the_references(shared):
    """Leaf names, shapes and dtypes equal ``jax.eval_shape`` of the
    reference's init (the router f32 under a bf16 ``param_dtype``)."""
    over = dict(param_dtype=jnp.bfloat16)
    jcfg = jconfigs.get_smoke_config(ARCH, **over)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_shared=shared))
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(k, jcfg))[0],
        jax.random.PRNGKey(0))
    ref = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(shapes).items()}
    tcfg = tconfigs.get_smoke_config(ARCH, param_dtype=torch.bfloat16)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, n_shared=shared))
    model = ttransformer.init_model(tcfg, torch.Generator().manual_seed(0))
    assert _port_tree(model) == ref
    assert ref["groups.0.0.ffn.router"][1] == "float32"


def test_full_width_counts_on_meta():
    cfg = tconfigs.get_config(ARCH, param_dtype=torch.bfloat16)
    model = ttransformer.init_model(cfg, None, "meta")
    n = ttransformer.count_params(model)
    jcfg = jconfigs.get_config(ARCH)
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(k, jcfg))[0],
        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes))
    assert n == 3_298_793_472           # 6.60 GB in bf16: one card
    assert model.groups[0][0].ffn["router"].dtype == torch.float32


def test_init_draws_the_reference_distributions():
    """Every expert leaf N(0, 1/E) (the reference's ``dense_init`` takes
    shape[0], the expert axis), the router N(0, 1/d), shared leaves N(0,
    1/fan_in)."""
    cfg = tconfigs.get_smoke_config(ARCH, d_model=256)
    cfg = dataclasses.replace(cfg, moe=tmoe.MoeConfig(
        d_model=256, n_experts=16, top_k=2, d_ff=128, n_shared=1))
    model = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    ffn, shared = model.groups[0][0].ffn, model.groups[0][0].ffn_shared
    for name in ("w_gate", "w_up", "w_down"):
        assert abs(ffn[name].std().item() * 16 ** 0.5 - 1.0) < 0.02, name
    assert abs(ffn["router"].std().item() * 256 ** 0.5 - 1.0) < 0.05
    assert abs(shared["w_gate"].std().item() * 256 ** 0.5 - 1.0) < 0.05
    assert abs(shared["w_down"].std().item() * 128 ** 0.5 - 1.0) < 0.05


def test_convert_carries_the_moe_leaves():
    _, _, tree, tcfg = _weights()
    model = params_from_numpy(tree, tcfg)
    ffn = tree["groups"][0][0]["ffn"]
    assert set(ffn) == {"router", "w_gate", "w_up", "w_down"} == \
        set(model.groups[0][0].ffn)
    for name, leaf in ffn.items():
        np.testing.assert_array_equal(model.groups[0][0].ffn[name].numpy(),
                                      leaf)
    assert model.groups[0][0].ffn_shared is None
    assert tcfg.tie_embeddings and model.head().shape == (64, 512)


def test_forward_matches_jax():
    """A 9-token prefill of two slots, then a decode step at position 9:
    logits within 1e-4 of JAX's (both route the call's 18, then 2, tokens
    together)."""
    cfg, params, tree, tcfg = _weights()
    model = params_from_numpy(tree, tcfg)
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
