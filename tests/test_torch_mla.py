"""MLA (multi-head latent attention, deepseek-v3) in the port against the
JAX package's ``mla_forward``.

At the reference's f32 smoke widths (d_model 64, 4 heads, q_lora 32,
kv_lora 16, qk_nope 16, qk_rope 8, v_dim 16) with the reference's
``init_mla`` weights from ``PRNGKey(0)``, ``q_norm`` / ``kv_norm`` moved
off their ones so that both norms count:

  * a prefill from position 0 and a decode step, outputs and latent cache
    within 1e-5 of JAX's;
  * a batch whose slots sit at different positions against one JAX call a
    slot (the reference's cached MLA takes one shared position);
  * the prefill's query-row blocking against one unblocked call;
  * the port's init drawing the reference's leaves and distributions;
  * the no-cache form (training, ROADMAP item 16.8) against JAX's and
    against the cached prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as ttransformer

RTOL, ATOL = 1e-5, 1e-5
SMOKE = dict(d_model=64, n_heads=4, q_lora=32, kv_lora=16, qk_nope=16,
             qk_rope=8, v_dim=16, q_chunk=64, kv_chunk=64)


def close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _weights():
    """(jax cfg, jax leaves, port cfg, port leaves): the reference's
    ``init_mla`` at the smoke widths, the norm scales perturbed."""
    jcfg = jattention.MlaConfig(**SMOKE)
    tree = jax.tree_util.tree_map(np.array, jblocks.split_params(
        jattention.init_mla(jax.random.PRNGKey(0), jcfg))[0])
    rng = np.random.default_rng(1)
    for name in ("q_norm", "kv_norm"):
        tree[name] = (tree[name] + 0.1 * rng.standard_normal(
            tree[name].shape)).astype(np.float32)
    return (jcfg, {k: jnp.asarray(v) for k, v in tree.items()},
            tattention.MlaConfig(**SMOKE),
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _jax_cache(B, S):
    c = SMOKE
    return {"ckv": jnp.zeros((B, S, c["kv_lora"]), jnp.float32),
            "kr": jnp.zeros((B, S, c["qk_rope"]), jnp.float32)}


def _port_cache(B, S):
    c = SMOKE
    return {"ckv": torch.zeros(B, S, c["kv_lora"]),
            "kr": torch.zeros(B, S, c["qk_rope"])}


def _x(rng, B, L):
    return rng.standard_normal((B, L, SMOKE["d_model"])).astype(np.float32)


def _positions(B, L, start=0):
    return np.broadcast_to(np.arange(start, start + L, dtype=np.int32),
                           (B, L)).copy()


def _jax_call(jcfg, jp, x, pos, cache, cache_pos):
    return jattention.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                  cache=cache,
                                  cache_pos=jnp.asarray(cache_pos, jnp.int32))


def test_prefill_then_decode_matches_jax():
    """Two slots prefill 11 tokens, then 3 decode steps at one position
    (where the reference's shared position is right): every output and
    the latent cache within 1e-5."""
    jcfg, jp, tcfg, tp = _weights()
    rng = np.random.default_rng(2)
    B, L, S = 2, 11, 20
    x = _x(rng, B, L)
    jy, jc = _jax_call(jcfg, jp, x, _positions(B, L), _jax_cache(B, S), 0)
    tc = _port_cache(B, S)
    ty = tattention.mla_forward(tp, torch.from_numpy(x),
                                torch.from_numpy(_positions(B, L)), tcfg,
                                tc, 0)
    close(ty, jy)
    for p in range(L, L + 3):
        x = _x(rng, B, 1)
        jy, jc = _jax_call(jcfg, jp, x, _positions(B, 1, p), jc, p)
        ty = tattention.mla_forward(
            tp, torch.from_numpy(x), torch.from_numpy(_positions(B, 1, p)),
            tcfg, tc, torch.full((B,), p, dtype=torch.int32))
        close(ty, jy)
    for name in ("ckv", "kr"):
        close(tc[name], jc[name])


def test_slots_at_their_own_positions_match_one_jax_call_a_slot():
    """Three slots prefilled with 3, 9 and 6 tokens (each through its own
    views of the batch cache), then two decode steps of the whole batch,
    each slot at its own position: each slot's output within 1e-5 of the
    reference run on that slot alone."""
    jcfg, jp, tcfg, tp = _weights()
    rng = np.random.default_rng(3)
    lens, S = (3, 9, 6), 16
    tc = _port_cache(len(lens), S)
    jcaches = []
    for b, n in enumerate(lens):
        x = _x(rng, 1, n)
        _, jc = _jax_call(jcfg, jp, x, _positions(1, n), _jax_cache(1, S), 0)
        jcaches.append(jc)
        tattention.mla_forward(tp, torch.from_numpy(x),
                               torch.from_numpy(_positions(1, n)), tcfg,
                               {k: v[b:b + 1] for k, v in tc.items()}, 0)
    for step in range(2):
        x = _x(rng, len(lens), 1)
        pos = np.array([n + step for n in lens], np.int32)
        ty = tattention.mla_forward(tp, torch.from_numpy(x),
                                    torch.from_numpy(pos[:, None]), tcfg, tc,
                                    torch.from_numpy(pos))
        for b, p in enumerate(pos):
            jy, jcaches[b] = _jax_call(jcfg, jp, x[b:b + 1],
                                       _positions(1, 1, int(p)),
                                       jcaches[b], int(p))
            close(ty[b:b + 1], jy)
    for b in range(len(lens)):
        for name in ("ckv", "kr"):
            close(tc[name][b:b + 1], jcaches[b][name])


@pytest.mark.parametrize("block", [1, 5, 7])
def test_query_row_blocking_matches_one_unblocked_call(block, monkeypatch):
    """A 23-token prefill in blocks of 1, 5 (a ragged last block of 3) and
    7 query rows gives the unblocked call's output and cache."""
    _, _, tcfg, tp = _weights()
    rng = np.random.default_rng(4)
    B, L, S = 2, 23, 32
    x = torch.from_numpy(_x(rng, B, L))
    pos = torch.from_numpy(_positions(B, L))
    whole_cache = _port_cache(B, S)
    monkeypatch.setattr(tattention, "MLA_Q_BLOCK", L)
    whole = tattention.mla_forward(tp, x, pos, tcfg, whole_cache, 0)
    monkeypatch.setattr(tattention, "MLA_Q_BLOCK", block)
    cache = _port_cache(B, S)
    got = tattention.mla_forward(tp, x, pos, tcfg, cache, 0)
    close(got, whole, rtol=1e-6, atol=1e-6)
    for name in ("ckv", "kr"):
        assert torch.equal(cache[name], whole_cache[name])


def test_init_draws_the_reference_leaves_and_distributions():
    """``mla_leaves`` names and shapes the reference's ``init_mla`` leaves;
    the port's init draws them N(0, 1/fan_in), ``wo`` N(0, 1/(H·v_dim)),
    the norm scales ones (at wider widths, so that the spread is sharp)."""
    ref = jblocks.split_params(jattention.init_mla(
        jax.random.PRNGKey(0), jattention.MlaConfig(**SMOKE)))[0]
    leaves = tattention.mla_leaves(tattention.MlaConfig(**SMOKE))
    assert {k: s for k, (s, _) in leaves.items()} == \
        {k: v.shape for k, v in ref.items()}
    wide = tattention.MlaConfig(d_model=512, n_heads=8, q_lora=256,
                                kv_lora=128, qk_nope=32, qk_rope=16, v_dim=32)
    cfg = ttransformer.ModelConfig(
        name="mla-init", family="moe", d_model=512, n_heads=8, n_kv=8,
        d_ff=64, vocab=64, groups=((("mla:mlp",), 2),), mla=wide)
    mixer = ttransformer.init_model(
        cfg, torch.Generator().manual_seed(0)).groups[0][0].mixer
    fan_in = {"w_dq": 512, "w_uq": 256, "w_dkv": 512, "w_kr": 512,
              "w_uk": 128, "w_uv": 128, "wo": 8 * 32}
    for name, (shape, std) in tattention.mla_leaves(wide).items():
        w = mixer[name]
        assert tuple(w.shape) == (2,) + shape, name
        if std is None:
            assert torch.equal(w, torch.ones_like(w)), name
        else:
            assert std == pytest.approx(fan_in[name] ** -0.5)
            assert abs(w.std().item() / std - 1) < 0.05, name
            assert abs(w.mean().item()) < 0.05 * std, name


def test_the_no_cache_form_is_refused_naming_its_item():
    """The no-cache form (the training forward, ROADMAP item 16.8) is no
    longer refused: K/V expanded from the latent, it equals the
    reference's ``mla_forward`` with no cache, and the cached prefill of
    the same tokens."""
    jcfg, jp, tcfg, tp = _weights()
    rng = np.random.default_rng(9)
    x, pos = _x(rng, 2, 7), _positions(2, 7)
    jy, jc = jattention.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                    jcfg)
    assert jc is None
    ty = tattention.mla_forward(tp, torch.from_numpy(x),
                                torch.from_numpy(pos), tcfg)
    close(ty, jy)
    cached = tattention.mla_forward(tp, torch.from_numpy(x),
                                    torch.from_numpy(pos), tcfg,
                                    _port_cache(2, 7), 0)
    close(ty, cached.numpy())
