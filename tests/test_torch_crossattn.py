"""Cross-attention models in the port against the JAX package:
llama-3.2-vision-11b (every fifth layer cross-attends stub image patches)
and, through the same pieces, whisper-medium (tests/test_torch_whisper.py
adds its encoder, layer norms, GELU MLP and learned positions).

At each arch's f32 smoke config, with the reference's ``PRNGKey(0)``
weights carried across by ``models/convert.py`` and every bias, norm
scale, norm bias and ``pos_embed`` perturbed by seeded numpy (at init the
biases are 0 and the scales 1: whisper's greedy stream is then one
repeated token), and ``extra`` from a seeded numpy normal:

  * ``attention.cross_forward`` at prefill and at decode against the
    reference's ``cross_forward`` (1e-5), the cross cache's contents too;
  * ``make_prefill_step`` then 70 ``make_decode_step`` calls against the
    JAX steps at a scalar ``cache_pos`` (logits within 1e-4 at every step,
    greedy streams equal); for whisper the run passes its ``learned_pos``
    of 64;
  * the decode step's ``[B]`` tensor form equal to the scalar form;
  * the configs' fields, ``n_layers()``, the full-width parameter counts
    on the ``meta`` device (9,775,157,248 and 813,500,416), the tree
    leaf for leaf, the init's leaves, the caches' shapes and bytes;
  * the refusals: the dense, monolithic and chunked engines, the paged
    pool and the CLI each raise a ValueError, and a prefill without
    ``extra`` too;
  * both steps in a process that imports neither ``jax`` nor ``repro``.

``train.step.attention_calls`` lists the attention-kernel calls of a
prefill and its decode steps; a test holds that list to the calls the
steps make. A ``cuda``-marked test walks the list at the full-width runs
of both archs (8 requests; the vlm's 256-token prompts over 2048 rows,
whisper's 4 over 448; 64 new tokens) and holds every call of
``flash_attention`` and ``flash_decode`` against its plain version on a
card; it skips without one.
"""
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
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.serve.kvcache import PagedCachePool as JPagedCachePool
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.kvcache import PagedCachePool as TPagedCachePool
from repro_torch.train import step as tstep

SRC = Path(__file__).resolve().parents[1] / "src"
VLM, AUDIO = "llama-3.2-vision-11b", "whisper-medium"
ARCHS = (VLM, AUDIO)
BIASES = ("scale", "bias", "bq", "bk", "bv", "b_in", "b_out")
B, PROMPT, MAX_SEQ, STEPS = 2, 8, 80, 70


def _perturb(tree, rng):
    """Every bias, norm scale and norm bias + N(0, 0.1²), every
    ``pos_embed`` + N(0, 0.02²), in place."""
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _perturb(v, rng)
        return
    for k, v in tree.items():
        if isinstance(v, np.ndarray):
            std = 0.1 if k in BIASES else 0.02 if k == "pos_embed" else 0
            if std:
                tree[k] = (v + std * rng.standard_normal(v.shape)).astype(
                    np.float32)
        else:
            _perturb(v, rng)


@functools.lru_cache(maxsize=None)
def weights(arch):
    """(jax cfg, jax params, numpy tree, port cfg) at the smoke config in
    f32, perturbed."""
    cfg = jconfigs.get_smoke_config(arch, compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    tree = jax.tree_util.tree_map(np.array, params)
    _perturb(tree, np.random.default_rng(1))
    tcfg = tconfigs.get_smoke_config(arch, compute_dtype=torch.float32)
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), tree, tcfg


@functools.lru_cache(maxsize=None)
def model(arch):
    _, _, tree, tcfg = weights(arch)
    return params_from_numpy(tree, tcfg)


def extra_for(cfg, batch, seed=2):
    """Stub encoder input [batch, encoder_seq, d] from a seeded normal:
    image patches (cross_kv_dim wide) or audio frames (d_model)."""
    width = cfg.cross_kv_dim if cfg.family == "vlm" else cfg.d_model
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.encoder_seq, width)).astype(
        np.float32)


def prompts(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def run_steps(arch):
    """The JAX and port steps side by side: a prefill of ``PROMPT`` tokens,
    then ``STEPS`` greedy decode steps at a scalar cache_pos, each side
    fed its own argmax. Returns (jax logits, port logits, jax stream, port
    stream), a [1 + STEPS, B, vocab] and a [1 + STEPS, B] pair."""
    cfg, params, _, tcfg = weights(arch)
    m = model(arch)
    toks, extra = prompts(cfg), extra_for(cfg, B)
    jl, jc = jax.jit(jstep.make_prefill_step(cfg))(
        params, jnp.asarray(toks), jtransformer.init_caches(cfg, B, MAX_SEQ),
        jnp.asarray(extra))
    tl, tc = tstep.make_prefill_step(tcfg)(
        m, torch.from_numpy(toks), ttransformer.init_caches(tcfg, B, MAX_SEQ),
        torch.from_numpy(extra))
    jdec, tdec = jax.jit(jstep.make_decode_step(cfg)), \
        tstep.make_decode_step(tcfg)
    jls, tls = [np.asarray(jl)[:, -1]], [tl[:, -1].numpy()]
    for pos in range(PROMPT, PROMPT + STEPS):
        jt = jls[-1].argmax(-1).astype(np.int32)[:, None]
        tt = torch.from_numpy(tls[-1].argmax(-1))[:, None]
        jl, jc = jdec(params, jnp.asarray(jt), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tdec(m, tt, tc, pos)
        assert tuple(tl.shape) == (B, 1, tcfg.vocab)
        jls.append(np.asarray(jl)[:, -1])
        tls.append(tl[:, -1].numpy())
    jls, tls = np.stack(jls), np.stack(tls)
    return jls, tls, jls.argmax(-1), tls.argmax(-1)


def _first_cross(arch):
    """The first cross layer's weights: (pattern position, numpy mixer)."""
    cfg, _, tree, _ = weights(arch)
    i = [jtransformer.parse_kind(k)[0] for k in cfg.groups[0][0]].index(
        "cross")
    return i, {k: v[0] for k, v in tree["groups"][0][i]["mixer"].items()}


# --------------------------------------------------------------------------
# the configs, the weights, the caches
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch):
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        for f in ("name", "family", "d_model", "n_heads", "n_kv", "d_ff",
                  "vocab", "groups", "mlp", "qkv_bias", "rope_theta",
                  "window", "norm", "tie_embeddings", "learned_pos",
                  "encoder_groups", "encoder_seq", "cross_kv_dim", "remat",
                  "q_chunk", "kv_chunk", "hd"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert t.n_layers() == j.n_layers(), get
    full = tconfigs.get_config(arch)
    assert full.n_layers() == {VLM: 40, AUDIO: 72}[arch]
    assert (full.d_model, full.n_heads, full.n_kv, full.hd, full.d_ff,
            full.vocab, full.encoder_seq) == {
        VLM: (4096, 32, 8, 128, 14336, 128256, 1600),
        AUDIO: (1024, 16, 16, 64, 4096, 51865, 1500)}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_counts_on_meta(arch):
    """The published widths on the ``meta`` device, as the reference's
    abstract shapes count (the vision tower and the audio front end are
    stubs in both packages)."""
    cfg = tconfigs.get_config(arch, param_dtype=torch.bfloat16)
    n = ttransformer.count_params(ttransformer.init_model(cfg, None, "meta"))
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(
            k, jconfigs.get_config(arch)))[0], jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes))
    assert n == {VLM: 9_775_157_248, AUDIO: 813_500_416}[arch]


def _port_names(tree, prefix=""):
    """The reference tree's leaves under the port's parameter names: a
    norm's scale under its name and its bias as ``<name>_bias``, a MoE's
    shared experts under ``ffn_shared``."""
    out = {}
    for k, v in tree.items():
        if k == "groups":
            for gi, group in enumerate(v):
                for i, pos in enumerate(group):
                    out.update(_port_names(pos, f"{prefix}groups.{gi}.{i}."))
        elif k == "encoder":
            out.update(_port_names(v, prefix + "encoder."))
        elif isinstance(v, dict) and "scale" in v:
            out[prefix + k] = v["scale"]
            if "bias" in v:
                out[prefix + k + "_bias"] = v["bias"]
        elif isinstance(v, dict):
            for name, leaf in v.items():
                out[f"{prefix}{k}.{name}"] = leaf
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf(arch):
    """Every leaf of the reference tree, ``pos_embed`` and the encoder
    subtree included, lands in the port's module, and nothing else."""
    tree = weights(arch)[2]
    got = dict(model(arch).named_parameters())
    want = _port_names(tree)
    assert set(got) == set(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_leaves(arch):
    """The port's own init: the reference's leaves and shapes, biases and
    layer-norm biases 0, scales 1, a cross layer without QKV biases (even
    under whisper's ``qkv_bias``) and with ``wk`` of fan-in
    ``cross_kv_dim``, ``pos_embed`` N(0, 0.02²)."""
    kw = dict(d_model=256, cross_kv_dim=128)
    cfg = tconfigs.get_smoke_config(arch, **kw)
    jcfg = jconfigs.get_smoke_config(arch, **kw)
    m = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    ref = jax.tree_util.tree_map(np.asarray, jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), jcfg))[0])
    want = _port_names(ref)
    got = dict(m.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for name, p in got.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bq", "bk", "bv", "b_in", "b_out") or \
                leaf.endswith("_bias"):
            assert not p.any(), name
        elif leaf.startswith(("ln", "final_norm")):
            assert bool((p == 1).all()), name
    i, _ = _first_cross(arch)
    cross = m.groups[0][i].mixer
    assert set(cross) == {"wq", "wk", "wv", "wo"}
    assert tuple(cross["wk"].shape[1:2]) == (128,)
    assert abs(cross["wk"].std().item() * 128 ** 0.5 - 1) < 0.05
    if cfg.learned_pos:
        assert abs(m.pos_embed.std().item() / 0.02 - 1) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_hold_encoder_seq_rows_for_cross_layers(arch):
    """A cross position's cache is [count, B, K, encoder_seq, hd] (the
    reference's ``_init_cache_one``), whatever ``max_seq``; at full width
    and the card's traffic the leaves come to the bytes the smoke gates."""
    cfg, _, _, tcfg = weights(arch)
    for S in (4, 32):
        ref = jtransformer.init_caches(cfg, 2, S)
        got = ttransformer.init_caches(tcfg, 2, S)
        for jg, tg in zip(ref, got):
            for jl, tl in zip(jg, tg):
                for name in ("k", "v"):
                    assert tuple(tl[name].shape) == jl[name].shape, S
    full = tconfigs.get_config(arch)
    seq = {VLM: 2048, AUDIO: 448}[arch]
    caches = ttransformer.init_caches(full, 8, seq, device="meta")
    by_kind = {"gqa": 0, "cross": 0}
    for (pattern, _), group in zip(full.groups, caches):
        for kind, leaves in zip(pattern, group):
            by_kind[ttransformer.parse_kind(kind)[0]] += sum(
                t.nbytes for t in leaves.values())
    assert by_kind == {VLM: {"gqa": 2_147_483_648, "cross": 419_430_400},
                       AUDIO: {"gqa": 352_321_536,
                               "cross": 1_179_648_000}}[arch]


# --------------------------------------------------------------------------
# cross_forward and the steps against JAX
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_forward_prefill_and_decode_match_jax(arch):
    """Prefill: the K/V projected from ``extra`` land in the cross cache
    (no bias, no RoPE) and the L queries attend all S_enc keys; decode:
    one query reads the cache, which stays as it was."""
    cfg, _, _, tcfg = weights(arch)
    _, mix = _first_cross(arch)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kv = extra_for(cfg, B)
    acfg = cfg.attn_cfg("cross")
    jm = {k: jnp.asarray(v) for k, v in mix.items()}
    jy, jc = jattention.cross_forward(jm, jnp.asarray(x), jnp.asarray(kv),
                                      acfg)
    tm = {k: torch.from_numpy(v) for k, v in mix.items()}
    shape = (B, tcfg.n_kv, tcfg.encoder_seq, tcfg.hd)
    cache = {n: torch.zeros(shape) for n in ("k", "v")}
    ty = tattention.cross_forward(tm, torch.from_numpy(x), tcfg, cache,
                                  torch.from_numpy(kv))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5)
    jy1, _ = jattention.cross_forward(jm, jnp.asarray(x1), None, acfg,
                                      cross_cache=jc)
    before = {n: t.clone() for n, t in cache.items()}
    ty1 = tattention.cross_forward(tm, torch.from_numpy(x1), tcfg, cache)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), atol=1e-5)
    assert all(torch.equal(cache[n], before[n]) for n in cache)
    with pytest.raises(ValueError, match="encoder states"):
        tattention.cross_forward(tm, torch.from_numpy(x), tcfg, cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_70_decode_steps_match_jax(arch):
    jls, tls, js, ts = run_steps(arch)
    np.testing.assert_allclose(tls, jls, atol=1e-4)
    np.testing.assert_array_equal(ts, js)
    assert len(set(ts[:, 0].tolist())) > 3       # not one repeated token
    cfg = weights(arch)[0]
    if cfg.learned_pos:                  # the run decodes past the table
        assert PROMPT + STEPS > cfg.learned_pos


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_takes_a_per_slot_tensor(arch):
    """``cache_pos`` as a [B] tensor (every slot at the same position) and
    as a 0-d tensor give the scalar form's logits bit for bit."""
    cfg, _, _, tcfg = weights(arch)
    m = model(arch)
    toks, extra = torch.from_numpy(prompts(cfg)), torch.from_numpy(
        extra_for(cfg, B))
    prefill, decode = (tstep.make_prefill_step(tcfg),
                       tstep.make_decode_step(tcfg))
    runs = []
    for form in (lambda p: p, lambda p: torch.tensor(p),
                 lambda p: torch.full((B,), p, dtype=torch.int32)):
        logits, caches = prefill(m, toks, ttransformer.init_caches(
            tcfg, B, MAX_SEQ), extra)
        out = [logits]
        for pos in range(PROMPT, PROMPT + 4):
            logits, caches = decode(m, out[-1][:, -1].argmax(-1)[:, None],
                                    caches, form(pos))
            out.append(logits)
        runs.append(torch.cat(out, dim=1))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("arch", ARCHS + ("gemma3-27b",))
def test_attention_calls_are_the_steps_calls(arch, monkeypatch):
    """Every ``flash_attention`` / ``flash_decode`` call of a prefill and
    its decode steps, recorded by shape, causality, window and lengths, is
    one that ``attention_calls`` lists, as many times (gemma3-27b's smoke
    config: local layers' rings of 8 rows, wrapped)."""
    tcfg = tconfigs.get_smoke_config(arch, compute_dtype=torch.float32)
    if arch in ARCHS:
        cfg, m = weights(arch)[0], model(arch)
        toks, extra = prompts(cfg), torch.from_numpy(extra_for(cfg, B))
    else:
        m = ttransformer.init_model(tcfg, torch.Generator().manual_seed(0))
        toks, extra = np.random.default_rng(3).integers(
            0, tcfg.vocab, (B, PROMPT)), None
    seen = []

    def flash_attention(q, k, v, causal, window=None, softcap=None):
        assert v.shape == k.shape
        seen.append(("flash_attention", tuple(q.shape), tuple(k.shape),
                     causal, window, ()))
        return tfa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)

    def flash_decode(q, kc, vc, lengths, softcap=None):
        assert vc.shape == kc.shape
        seen.append(("flash_decode", tuple(q.shape), tuple(kc.shape), False,
                     None, tuple(lengths.tolist())))
        return tda.flash_decode(q, kc, vc, lengths, softcap=softcap)

    monkeypatch.setattr(tattention, "flash_attention", flash_attention)
    monkeypatch.setattr(tattention, "flash_decode", flash_decode)
    n_new = 12
    logits, caches = tstep.make_prefill_step(tcfg)(
        m, torch.from_numpy(toks), ttransformer.init_caches(tcfg, B, MAX_SEQ),
        extra)
    decode = tstep.make_decode_step(tcfg)
    for pos in range(PROMPT, PROMPT + n_new - 1):
        logits, caches = decode(m, logits[:, -1].argmax(-1)[:, None], caches,
                                pos)
    want = Counter()
    calls = tstep.attention_calls(tcfg, B, PROMPT, MAX_SEQ, n_new)
    for c in calls:
        assert c.group == tcfg.n_heads // tcfg.n_kv
        if c.kernel == "flash_attention":
            want[(c.kernel, c.q, c.kv, c.causal, c.window, ())] += c.layers
        for n in c.lengths:
            want[(c.kernel, c.q, c.kv, False, None, (n,) * B)] += c.layers
    assert Counter(seen) == want
    assert sum(c.launches for c in calls) == len(seen)
    if arch == "gemma3-27b":          # a ring wrapped: lengths stop at 8
        assert max(n for c in calls if c.window
                   for n in c.lengths) == tcfg.window


def test_vlm_extra_reaches_the_cross_layers_alone():
    """The vlm has no encoder: ``extra`` goes straight to its cross layers
    (another image, other logits), and a prefill without it raises."""
    cfg, _, _, tcfg = weights(VLM)
    m = model(VLM)
    assert m.encoder is None and m.pos_embed is None
    toks = torch.from_numpy(prompts(cfg))
    prefill = tstep.make_prefill_step(tcfg)
    a = prefill(m, toks, ttransformer.init_caches(tcfg, B, 16),
                torch.from_numpy(extra_for(cfg, B, seed=2)))[0]
    b = prefill(m, toks, ttransformer.init_caches(tcfg, B, 16),
                torch.from_numpy(extra_for(cfg, B, seed=5)))[0]
    assert not torch.allclose(a, b)
    with pytest.raises(ValueError, match="extra"):
        prefill(m, toks, ttransformer.init_caches(tcfg, B, 16))


def test_steps_refuse_weights_off_the_compute_dtype():
    _, _, tree, _ = weights(VLM)
    tcfg = tconfigs.get_smoke_config(VLM)               # bf16 compute
    m = params_from_numpy(tree, tcfg)                   # f32 leaves
    with pytest.raises(ValueError, match="compute dtype"):
        tstep.make_prefill_step(tcfg)(m, torch.zeros(1, 2, dtype=torch.long),
                                      None, None)


def test_the_steps_run_without_jax_or_the_reference():
    """Both archs' smoke configs through a prefill and a decode step in a
    process that never imports ``jax`` or ``repro``."""
    code = ("import sys, torch\n"
            "from repro_torch import configs\n"
            "from repro_torch.models import transformer\n"
            "from repro_torch.train import step\n"
            f"for arch in {ARCHS!r}:\n"
            "    cfg = configs.get_smoke_config(arch, "
            "compute_dtype=torch.float32)\n"
            "    m = transformer.init_model(cfg, "
            "torch.Generator().manual_seed(0))\n"
            "    c = transformer.init_caches(cfg, 1, 8)\n"
            "    x = torch.zeros(1, cfg.encoder_seq, cfg.d_model)\n"
            "    lg, c = step.make_prefill_step(cfg)(m, "
            "torch.zeros(1, 2, dtype=torch.long), c, x)\n"
            "    lg, c = step.make_decode_step(cfg)(m, "
            "lg[:, -1].argmax(-1)[:, None], c, 2)\n"
            "    assert lg.shape == (1, 1, cfg.vocab)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ISOLATED')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=SRC,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr


# --------------------------------------------------------------------------
# the refusals: no engine serves these archs, as in the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ("dense", "monolithic", "chunked"))
def test_engines_refuse_cross_attention_archs(arch, engine):
    _, _, _, tcfg = weights(arch)
    conf = TEngineConfig(n_slots=2, max_seq=32, chunked=engine == "chunked",
                         cache=TCacheConfig(paged=engine != "dense",
                                            page_tokens=8))
    with pytest.raises(ValueError, match="make_prefill_step"):
        TEngine(tcfg, model(arch), config=conf, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_pool_refuses_cross_as_the_reference(arch):
    cfg, _, _, tcfg = weights(arch)
    with pytest.raises(ValueError, match="mixer 'cross' is not pageable"):
        JPagedCachePool(cfg, 2, 32, 8, 8)
    with pytest.raises(ValueError, match="mixer 'cross' is not pageable"):
        TPagedCachePool(tcfg, 2, 32, 8, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_refuses_cross_attention_archs(arch):
    with pytest.raises(ValueError, match="make_decode_step"):
        tserve.main(["--device", "cpu", "--arch", arch, "--requests", "1"])


# --------------------------------------------------------------------------
# on the card: the kernels at this path's full-width shapes
# --------------------------------------------------------------------------
def _within(out, plain, tol=2e-3):
    """|kernel - plain| <= tol, plus one bf16 rounding step of the value
    (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    x = plain.float().abs()
    step = torch.exp2(torch.floor(torch.log2(x.clamp_min(2.0**-126))) - 7)
    lim = tol + torch.where(x > 0, step, 0.0)
    return bool(((out.float() - plain.float()).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_kernels_at_the_cross_attention_shapes(arch):
    """Every attention-kernel call of the full-width run (8 requests, 64
    new tokens; llama-vision's 256-token prompts over 2048 rows, whisper's
    4 over 448), bf16, against its plain version: ``flash_attention`` at
    each prefill shape (the encoder's 1500 frames, the causal self
    prefills, the cross prefills with Lq ≠ Lk, kv heads repeated) and
    ``flash_decode`` at every step's lengths (S 1500 / 1600 for the cross
    caches: 1500 is no multiple of the 64-key split); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_crossattn.py)")
    prompt, max_seq = {VLM: (256, 2048), AUDIO: (4, 448)}[arch]
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    for c in tstep.attention_calls(tconfigs.get_config(arch), 8, prompt,
                                   max_seq, 64):
        q = torch.randn(c.q, generator=g, device="cuda").to(bf16)
        if c.kernel == "flash_attention":
            Bq, H, Lk, hd = c.kv
            k, v = (torch.randn(Bq, H // c.group, Lk, hd, generator=g,
                                device="cuda").to(bf16)
                    .repeat_interleave(c.group, 1) for _ in range(2))
            kw = dict(causal=c.causal, window=c.window)
            n0 = tfa.flash_attention.launches
            out = tfa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert tfa.flash_attention.launches == n0 + 1
            assert _within(out, tfa.flash_attention_plain(q, k, v, **kw)), c
            continue
        kc, vc = (torch.randn(c.kv, generator=g, device="cuda").to(bf16)
                  for _ in range(2))
        for n in sorted(set(c.lengths)):
            lens = torch.full((c.q[0],), n, dtype=torch.int32, device="cuda")
            n0 = tda.flash_decode.launches
            out = tda.flash_decode(q, kc, vc, lens)
            torch.cuda.synchronize()
            assert tda.flash_decode.launches == n0 + 1
            assert _within(out, tda.flash_decode_plain(q, kc, vc, lens)), \
                (c.mixer, n)
