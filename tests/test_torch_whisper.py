"""whisper-medium in the port against the JAX package: layer norms with
biases, the tanh GELU MLP with biases, learned positions and the encoder.

At the f32 smoke config with the reference's ``PRNGKey(0)`` weights
carried across and every bias, norm scale, norm bias and ``pos_embed``
perturbed (tests/test_torch_crossattn.py's weights, which also hold the
steps, the cross layers and the refusals of both archs against JAX):

  * ``blocks.layer_norm`` and ``blocks.gelu_mlp`` against the reference's
    blocks (1e-6), bf16 cast back as the reference casts;
  * ``transformer.encode`` against the reference's ``_encode`` (1e-5) on
    a whole clip and on fewer frames than ``encoder_seq``;
  * learned positions clipped at ``learned_pos - 1``: decode steps at
    and past the table's end against the JAX step;
  * decode never re-encodes: the cross caches written at prefill are what
    every decode step reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.train import step as jstep
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttransformer
from repro_torch.train import step as tstep
from test_torch_crossattn import AUDIO, extra_for, model, prompts, weights


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((3, 5, 64))).astype(np.float32)
    s, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    exp = np.asarray(jblocks.layer_norm(jnp.asarray(s), jnp.asarray(b),
                                        jnp.asarray(x, dtype)), np.float32)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = tblocks.layer_norm(torch.from_numpy(s), torch.from_numpy(b),
                             torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), exp, atol=1e-6)


def test_gelu_mlp_matches_jax():
    """The tanh approximation, biases on both products."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 7, 16)).astype(np.float32)
    w_in = (0.3 * rng.standard_normal((16, 32))).astype(np.float32)
    w_out = (0.3 * rng.standard_normal((32, 16))).astype(np.float32)
    b_in = rng.standard_normal(32).astype(np.float32)
    b_out = rng.standard_normal(16).astype(np.float32)
    args = (w_in, b_in, w_out, b_out, x)
    got = tblocks.gelu_mlp(*(torch.from_numpy(a) for a in args))
    exp = jblocks.gelu_mlp(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x @ w_in + b_in))
    assert not np.allclose(erf.numpy() @ w_out + b_out, np.asarray(exp),
                           atol=1e-6)      # not the exact (erf) GELU


@pytest.mark.parametrize("frames", [16, 11])
def test_encoder_matches_jax(frames):
    """The encoder over a whole clip (``encoder_seq`` frames) and a shorter
    one (``pos_embed[:S]``)."""
    cfg, params, _, _ = weights(AUDIO)
    x = extra_for(cfg, 2)[:, :frames]
    exp = jtransformer._encode(params["encoder"], jnp.asarray(x), cfg)
    got = ttransformer.encode(model(AUDIO), torch.from_numpy(x))
    assert tuple(got.shape) == (2, frames, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5)
    with pytest.raises(ValueError, match="learned positions"):
        ttransformer.encode(model(AUDIO), torch.zeros(1, 17, cfg.d_model))


def test_learned_positions_clip_at_the_last_row():
    """Past ``learned_pos`` a token takes row ``learned_pos - 1``, as the
    reference clips (``take(pe, clip(positions, 0, learned_pos - 1))``):
    one decode step at 63, 64 and 200 after the same prefill, against the
    JAX step at the same scalar ``cache_pos`` (1e-4); an unclipped lookup
    would index past the 64-row table."""
    cfg, params, _, tcfg = weights(AUDIO)
    assert tcfg.learned_pos == 64
    toks, extra = prompts(cfg), extra_for(cfg, 2)
    jdec = jax.jit(jstep.make_decode_step(cfg))
    for pos in (63, 64, 200):
        _, jc = jax.jit(jstep.make_prefill_step(cfg))(
            params, jnp.asarray(toks), jtransformer.init_caches(cfg, 2, 256),
            jnp.asarray(extra))
        _, tc = tstep.make_prefill_step(tcfg)(
            model(AUDIO), torch.from_numpy(toks),
            ttransformer.init_caches(tcfg, 2, 256), torch.from_numpy(extra))
        tok = toks[:, -1:]
        jl, _ = jdec(params, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
        tl, _ = tstep.make_decode_step(tcfg)(
            model(AUDIO), torch.from_numpy(tok), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   err_msg=str(pos))


def test_decode_never_reencodes():
    """The cross caches after the prefill hold the projections of the
    encoder's output; decode steps leave them as they are, and another
    ``extra`` given to a decode step changes nothing (it is not read)."""
    cfg, _, _, tcfg = weights(AUDIO)
    m = model(AUDIO)
    caches = ttransformer.init_caches(tcfg, 2, 32)
    extra = torch.from_numpy(extra_for(cfg, 2))
    logits, caches = tstep.make_prefill_step(tcfg)(
        m, torch.from_numpy(prompts(cfg)), caches, extra)
    enc = ttransformer.encode(m, extra)
    cross = caches[0][1]
    wk = m.groups[0][1].mixer["wk"][0]
    want = (enc @ wk).reshape(2, 16, tcfg.n_kv, tcfg.hd).transpose(1, 2)
    torch.testing.assert_close(cross["k"][0], want, atol=1e-6, rtol=0)
    before = {n: t.clone() for n, t in cross.items()}
    tok = logits[:, -1].argmax(-1)[:, None]
    a = ttransformer.forward(m, tok, caches, torch.full((2,), 8), "decode")[0]
    b = ttransformer.forward(m, tok, caches, torch.full((2,), 8), "decode",
                             extra=torch.zeros_like(extra))[0]
    assert torch.equal(a, b)
    assert all(torch.equal(cross[n], before[n]) for n in cross)
