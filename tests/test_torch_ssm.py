"""models/ssm.py in the port against the JAX package, function by function.

Inputs come from numpy seeds; the JAX side runs on the CPU in f32. Every
comparison is at rtol 1e-5 (an absolute floor of 1e-6 for values near 0):

  * ``gla_chunked`` with L below, at and above ``chunk`` (a ragged last
    chunk), with and without ``log_gate`` and ``state0``; ``gla_step``
    continuing it token by token; ``causal_conv`` with and without state;
  * ``mamba2_forward``, ``mlstm_forward`` and ``slstm_forward`` on a prompt
    (no state, and a zero state that comes back filled) and then step by
    step (decode, a one-token prompt included), with the reference's
    weights (norm scales, ``D`` and ``dt_bias`` perturbed);
  * the port's leaf tables (``ssm.LEAVES``) against the reference's init;
  * ``repro_torch.models.ssm`` imports without JAX.

The helpers at the bottom (weights, engines, the no-cache greedy loop)
serve tests/test_torch_xlstm.py and tests/test_torch_zamba2.py.
"""
import functools
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
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.engine import Request as TRequest

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL, ATOL = 1e-5, 1e-6


def close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _gla_inputs(rng, B, L, H, N, P):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = 0.5 * f(B, L, H, N), 0.5 * f(B, L, H, N), f(B, L, H, P)
    ld = -np.logaddexp(0, f(B, L, H)).astype(np.float32)       # ≤ 0
    lg = np.clip(f(B, L, H), -2, 2)
    S0 = f(B, H, N, P)
    return q, k, v, ld, lg, S0


# --------------------------------------------------------------------------
# the gla core and the conv
# --------------------------------------------------------------------------
@pytest.mark.parametrize("gate,state", [(False, False), (True, False),
                                        (True, True), (False, True)])
@pytest.mark.parametrize("L", [5, 8, 21])
def test_gla_chunked_matches_jax(L, gate, state):
    """chunk 8: L 5 (one short chunk), 8 (one whole), 21 (a ragged third
    chunk of 5 rows, zero-padded and sliced off)."""
    rng = np.random.default_rng(L)
    q, k, v, ld, lg, S0 = _gla_inputs(rng, 2, L, 3, 4, 5)
    kw = dict(chunk=8)
    jy, jS = jssm.gla_chunked(
        *map(jnp.asarray, (q, k, v, ld)),
        log_gate=jnp.asarray(lg) if gate else None,
        state0=jnp.asarray(S0) if state else None, **kw)
    ty, tS = tssm.gla_chunked(
        *map(_t, (q, k, v, ld)), log_gate=_t(lg) if gate else None,
        state0=_t(S0) if state else None, **kw)
    assert ty.shape == (2, L, 3, 5) and tS.dtype == torch.float32
    close(ty, jy)
    close(tS, jS)


def test_gla_step_continues_gla_chunked_as_jax():
    """13 tokens chunked (chunk 8), then 3 single-token steps: each step's
    output and state against JAX's same chain; the chain's outputs also
    equal one chunked pass over all 16 tokens."""
    rng = np.random.default_rng(0)
    q, k, v, ld, lg, S0 = _gla_inputs(rng, 2, 16, 3, 4, 5)
    args = (q, k, v, ld, lg)
    jy, jS = jssm.gla_chunked(*(jnp.asarray(a[:, :13]) for a in args[:4]),
                              log_gate=jnp.asarray(lg[:, :13]), chunk=8,
                              state0=jnp.asarray(S0))
    ty, tS = tssm.gla_chunked(*(_t(a[:, :13]) for a in args[:4]),
                              log_gate=_t(lg[:, :13]), chunk=8,
                              state0=_t(S0))
    close(tS, jS)
    outs = [ty]
    for t in range(13, 16):
        jy1, jS = jssm.gla_step(jS, *(jnp.asarray(a[:, t]) for a in args))
        ty1, tS = tssm.gla_step(tS, *(_t(a[:, t]) for a in args))
        close(ty1, jy1)
        close(tS, jS)
        outs.append(ty1[:, None])
    whole, S16 = tssm.gla_chunked(*(_t(a) for a in args[:4]),
                                  log_gate=_t(lg), chunk=8, state0=_t(S0))
    close(torch.cat(outs, dim=1), whole.numpy(), rtol=1e-4, atol=1e-5)
    close(tS, S16.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv_matches_jax(state):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    s = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jy, jst = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(s) if state else None)
    ty, tst = tssm.causal_conv(_t(x), _t(w), _t(s) if state else None)
    close(ty, jy)
    if state:
        close(tst, jst)
    else:
        assert tst is None and jst is None


# --------------------------------------------------------------------------
# the three mixers
# --------------------------------------------------------------------------
MIXERS = {   # kind: (config, reference init, reference forward, port fwd)
    "mamba": (jssm.Mamba2Config(d_model=16, d_state=4, head_dim=8, chunk=4),
              jssm.init_mamba2, jssm.mamba2_forward, tssm.mamba2_forward),
    "mlstm": (jssm.MlstmConfig(d_model=16, n_heads=2, chunk=4),
              jssm.init_mlstm, jssm.mlstm_forward, tssm.mlstm_forward),
    "slstm": (jssm.SlstmConfig(d_model=16, n_heads=2),
              jssm.init_slstm, jssm.slstm_forward, tssm.slstm_forward)}
PORT_CFG = {"mamba": tssm.Mamba2Config, "mlstm": tssm.MlstmConfig,
            "slstm": tssm.SlstmConfig}


def _jax_state(kind, cfg, B):
    if kind == "mamba":
        return jssm.mamba2_init_state(cfg, B)
    if kind == "mlstm":
        return jssm.mlstm_init_state(cfg, B)
    return jssm.slstm_init_state(cfg, B)


def _jitted(fwd, cfg):
    """The reference forward under ``jax.jit`` (``fwd(p, x, state)``): one
    compile a shape instead of eager op-by-op dispatch."""
    return jax.jit(lambda p, x, state: fwd(p, x, cfg, state=state))


@functools.lru_cache(maxsize=None)
def _mixer_weights(kind):
    cfg, init = MIXERS[kind][:2]
    p = jblocks.split_params(init(jax.random.PRNGKey(1), cfg))[0]
    p = {k: np.array(v) for k, v in p.items()}
    rng = np.random.default_rng(2)
    for name in ("norm", "D", "dt_bias"):     # init: ones / zeros
        if name in p:
            p[name] = (p[name] + 0.1 * rng.standard_normal(
                p[name].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_port_leaf_tables_are_the_reference_init(kind):
    """``ssm.LEAVES`` names the reference's leaves with their shapes, and
    the mLSTM's ``w_if`` is the one leaf drawn in f32 under bf16."""
    cfg, init = MIXERS[kind][:2]
    ref = jax.eval_shape(lambda key: jblocks.split_params(
        init(key, cfg, dtype=jnp.bfloat16))[0], jax.random.PRNGKey(0))
    port = tssm.LEAVES[kind](PORT_CFG[kind](**vars(cfg)))
    assert {k: tuple(v.shape) for k, v in ref.items()} == \
        {k: shape for k, (shape, _) in port.items()}
    assert {k for k, v in ref.items() if v.dtype == jnp.float32} == \
        ({"w_if"} if kind == "mlstm" else set())


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_prefill_then_decode_matches_jax(kind):
    """A 10-token prompt without state (output only), again from a zero
    state (output and the state it returns), then 3 decode steps carrying
    the state: every output and state leaf against JAX's."""
    cfg, _, jfwd, tfwd = MIXERS[kind]
    jfwd = _jitted(jfwd, cfg)
    tcfg = PORT_CFG[kind](**vars(cfg))
    p = _mixer_weights(kind)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(3)
    B, L = 2, 10
    x = rng.standard_normal((B, L + 3, cfg.d_model)).astype(np.float32)
    jy, none = jfwd(jp, jnp.asarray(x[:, :L]), None)
    ty, tnone = tfwd(tp, _t(x[:, :L]), tcfg)
    assert none is None and tnone is None
    close(ty, jy)
    jst = _jax_state(kind, cfg, B)
    tst = {k: _t(v) for k, v in jst.items()}
    jy, jst = jfwd(jp, jnp.asarray(x[:, :L]), jst)
    ty, tst = tfwd(tp, _t(x[:, :L]), tcfg, state=tst)
    close(ty, jy)
    for t in range(L, L + 3):
        jy, jst = jfwd(jp, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tfwd(tp, _t(x[:, t:t + 1]), tcfg, state=tst)
        close(ty, jy)
        assert set(tst) == set(jst)
        for name in jst:
            assert tst[name].dtype == torch.float32 or name == "conv"
            close(tst[name], jst[name])


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_one_token_prompt_with_state_takes_the_step(kind):
    """A one-token input with a state is a decode (``gla_step``) in both
    packages, a one-token prompt included: equal outputs and state."""
    cfg, _, jfwd, tfwd = MIXERS[kind]
    p = _mixer_weights(kind)
    x = np.random.default_rng(4).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32)
    jst = _jax_state(kind, cfg, 2)
    jy, jst = jfwd({k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x), cfg, state=jst)
    ty, tst = tfwd({k: _t(v) for k, v in p.items()}, _t(x),
                   PORT_CFG[kind](**vars(cfg)),
                   state={k: torch.zeros(v.shape, dtype=torch.float32)
                          for k, v in jst.items()})
    close(ty, jy)
    for name in jst:
        close(tst[name], jst[name])


def test_ssm_module_imports_without_jax():
    code = ("import sys\n"
            "import repro_torch.models.ssm\n"
            "from repro_torch import configs\n"
            "from repro_torch.models import transformer\n"
            "for arch in ('xlstm-1.3b', 'zamba2-1.2b'):\n"
            "    transformer.init_model(configs.get_config(arch), None, "
            "'meta')\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ISOLATED')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=SRC,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr


# --------------------------------------------------------------------------
# helpers for tests/test_torch_xlstm.py and tests/test_torch_zamba2.py
# --------------------------------------------------------------------------
COUNTERS = ("decode_steps", "decode_tokens", "prefills", "admission_refusals",
            "token_fetches", "tokens_fetched")
PERTURBED = ("norm", "D", "dt_bias", "scale")   # init: ones / zeros


@functools.lru_cache(maxsize=None)
def arch_weights(arch, perturb=False):
    """(jax cfg, jax params, numpy tree, port cfg): the smoke config in f32
    from ``PRNGKey(0)``; with ``perturb``, every norm scale, ``D`` and
    ``dt_bias`` moved by N(0, 0.1²) (at init they are ones and zeros)."""
    cfg = jconfigs.get_smoke_config(arch, compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    tree = jax.tree_util.tree_map(np.array, params)
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
    tcfg = tconfigs.get_smoke_config(arch, compute_dtype=torch.float32)
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), tree, tcfg


@functools.lru_cache(maxsize=None)
def arch_model(arch, perturb=False):
    tree, tcfg = arch_weights(arch, perturb)[2:]
    return params_from_numpy(tree, tcfg)


def prompts_of(arch, lens, seed, low=0):
    rng = np.random.default_rng(seed)
    vocab = arch_weights(arch)[0].vocab
    return [rng.integers(low, vocab, n).astype(np.int32) for n in lens]


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


def jax_engine(arch, **kw):
    cfg, params = arch_weights(arch)[:2]
    return JEngine(cfg, params, config=JEngineConfig(max_seq=64, **kw))


def port_engine(arch, **kw):
    kw.setdefault("max_seq", 64)
    return TEngine(arch_weights(arch)[3], arch_model(arch), device="cpu",
                   config=TEngineConfig(**kw))


def jax_dense(arch, prompts, max_new, n_slots):
    eng = jax_engine(arch, n_slots=n_slots)
    return serve(eng, JRequest, prompts, max_new), counters(eng)


def port_dense(arch, prompts, max_new, n_slots, max_seq=64):
    eng = port_engine(arch, n_slots=n_slots, max_seq=max_seq)
    streams = serve(eng, TRequest, prompts, max_new)
    assert (eng.pool.seq_ids < 0).all() and not eng.pool.lengths.any()
    return streams, counters(eng)


@functools.lru_cache(maxsize=None)
def jax_prefill(cfg):
    """The reference's ``make_prefill_step`` under ``jax.jit``."""
    return jax.jit(jstep.make_prefill_step(cfg))


@functools.lru_cache(maxsize=None)
def jax_decode(cfg):
    """The reference's ``make_decode_step`` under ``jax.jit``."""
    return jax.jit(jstep.make_decode_step(cfg))


NOCACHE_ROWS, NOCACHE_LEN = 8, 80   # every no-cache call at one shape


@functools.lru_cache(maxsize=None)
def _nocache_fn(arch):
    cfg, params = arch_weights(arch)[:2]
    fwd = jax.jit(lambda p, t: jtransformer.forward(p, t, cfg)[0])
    return functools.partial(fwd, params)


def nocache_greedy(arch, prompts, max_new):
    """Greedy streams from JAX's no-cache forward (every layer causal, so
    padding after a row's end changes none of its positions), the rows
    padded to one shape."""
    rows = [list(p) for p in prompts]
    out = [[] for _ in prompts]
    assert len(rows) <= NOCACHE_ROWS
    for _ in range(max_new):
        toks = np.zeros((NOCACHE_ROWS, NOCACHE_LEN), np.int32)
        for i, r in enumerate(rows):
            toks[i, :len(r)] = r
        logits = np.asarray(_nocache_fn(arch)(jnp.asarray(toks)))
        for i, r in enumerate(rows):
            tok = int(np.argmax(logits[i, len(r) - 1]))
            out[i].append(tok)
            r.append(tok)
    return dict(enumerate(out))


# the case that shows the reference's state leak: four 8-token prompts from
# default_rng(1) (ids from 1), 6 new tokens each, max_seq 64
LEAK_PROMPTS = dict(lens=(8, 8, 8, 8), seed=1, low=1)


def check_the_reference_leaks_state_into_reused_slots(arch):
    """With 4 slots every stream of the JAX dense engine equals its request
    served alone; with 2, requests 2 and 3 (the ones that land in reused
    slots) part from theirs. The port gives the solo streams in both, and
    with 4 slots the JAX engine's counters too."""
    prompts = prompts_of(arch, **LEAK_PROMPTS)
    solo = {i: jax_dense(arch, [p], 6, 1)[0][0] for i, p in
            enumerate(prompts)}
    four = jax_dense(arch, prompts, 6, 4)
    two = jax_dense(arch, prompts, 6, 2)[0]
    assert four[0] == solo
    assert [two[i] == solo[i] for i in range(4)] == [True, True, False, False]
    assert port_dense(arch, prompts, 6, 4) == four
    assert port_dense(arch, prompts, 6, 2)[0] == solo
