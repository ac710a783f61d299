"""The port's model blocks, weights and paged steps against the JAX reference.

Same inputs (numpy, seeded) through both packages, f32 on the CPU. The
reference's QKV biases are zero at init, so the carried weights get
perturbed non-zero biases to exercise the bias path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.serve import paged_step as jstep
from repro_torch import configs as tconfigs
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import paged_step as tstep


def _weights(seed=0):
    """(jax cfg, jax params, numpy tree, port cfg) at the smoke config in
    f32, with perturbed QKV biases."""
    cfg = jconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(seed), cfg))[0]
    tree = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed + 1)
    for gp in tree["groups"]:
        for pos in gp:
            for b in ("bq", "bk", "bv"):
                pos["mixer"][b] = (pos["mixer"][b] + 0.1 * rng.standard_normal(
                    pos["mixer"][b].shape)).astype(np.float32)
    tcfg = tconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32)
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), tree, tcfg


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    got = tblocks.rms_norm(torch.from_numpy(s), torch.from_numpy(x))
    exp = jblocks.rms_norm(jnp.asarray(s), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5)


@pytest.mark.parametrize("hd", [16, 64])
def test_apply_rope_half_split_matches_jax(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    got = tblocks.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    exp = jblocks.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5)


def test_swiglu_and_embed_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 32)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((32, 16)).astype(np.float32) * 0.2
    got = tblocks.swiglu(*(torch.from_numpy(a) for a in (wg, wu, wd, x)))
    exp = jblocks.swiglu(*(jnp.asarray(a) for a in (wg, wu, wd, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tblocks.embed_lookup(torch.from_numpy(table),
                             torch.from_numpy(ids)).numpy(),
        np.asarray(jblocks.embed_lookup(jnp.asarray(table),
                                        jnp.asarray(ids))))


# --------------------------------------------------------------------------
# configuration and weights
# --------------------------------------------------------------------------
def test_full_width_config_counts_494m_parameters_on_meta():
    """qwen2-0.5b at its published width, counted without allocating, and
    equal to the reference's own count (from abstract shapes)."""
    cfg = tconfigs.get_config("qwen2-0.5b")
    assert (cfg.n_layers(), cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
            cfg.d_ff, cfg.vocab) == (24, 896, 14, 2, 64, 4864, 151936)
    model = ttransformer.init_model(cfg, None, "meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    n = ttransformer.count_params(model)
    jcfg = jconfigs.get_config("qwen2-0.5b")
    shapes = jax.eval_shape(
        lambda k: jblocks.split_params(jtransformer.init_model(k, jcfg))[0],
        jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes))
    assert n == n_ref
    assert 490e6 < n < 500e6


def test_compute_dtype_override_and_unported_arch():
    cfg = tconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32)
    assert cfg.compute_dtype is torch.float32
    assert tconfigs.get_config("qwen2-0.5b").compute_dtype is torch.bfloat16
    with pytest.raises(NotImplementedError):
        tconfigs.get_config("yi-34b")


def test_convert_copies_every_leaf_and_init_draws_reference_scales():
    _, _, tree, tcfg = _weights()
    model = params_from_numpy(tree, tcfg)
    np.testing.assert_array_equal(model.embed.numpy(), tree["embed"])
    pos = model.groups[0][0]
    for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        np.testing.assert_array_equal(
            pos.mixer[name].numpy(), tree["groups"][0][0]["mixer"][name])
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            pos.ffn[name].numpy(), tree["groups"][0][0]["ffn"][name])
    np.testing.assert_array_equal(pos.ln1.numpy(),
                                  tree["groups"][0][0]["ln1"]["scale"])
    # random init: the reference's distributions (not its numbers)
    cfg = tconfigs.get_smoke_config("qwen2-0.5b", d_model=256, n_heads=4,
                                    d_ff=512)
    m = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    wq = m.groups[0][0].mixer["wq"]
    assert abs(wq.std().item() * 256 ** 0.5 - 1.0) < 0.05
    assert abs(m.embed.std().item() / 0.02 - 1.0) < 0.05
    assert torch.count_nonzero(m.groups[0][0].mixer["bq"]) == 0


# --------------------------------------------------------------------------
# paged steps
# --------------------------------------------------------------------------
def _pools(rng, cfg, n_pages, pt):
    count = cfg.groups[0][1]
    shape = (count, n_pages, cfg.n_kv, pt, cfg.hd)
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}


def test_paged_decode_step_matches_jax():
    """Logits within 1e-4, equal argmax, equal written pages, and an
    inactive slot whose table row would clamp to page 0 (owned by a live
    slot) leaves the pool bit-untouched."""
    cfg, params, tree, tcfg = _weights()
    pt, n_pages = 8, 8
    rng = np.random.default_rng(3)
    pools = _pools(rng, cfg, n_pages, pt)
    table = np.array([[0, 3, -1], [-1, -1, -1], [5, 2, -1]], np.int32)
    lengths = np.array([9, 4, 12], np.int32)
    active = np.array([True, False, True])
    tokens = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)

    jlogits, jpages = jstep.make_paged_decode_step(cfg, pt)(
        params, jnp.asarray(tokens),
        [({n: jnp.asarray(a) for n, a in pools.items()},)],
        jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(active))
    model = params_from_numpy(tree, tcfg)
    tpages = [({n: torch.from_numpy(a.copy()) for n, a in pools.items()},)]
    tlogits, out = tstep.make_paged_decode_step(tcfg, pt)(
        model, torch.from_numpy(tokens), tpages, torch.from_numpy(table),
        torch.from_numpy(lengths), torch.tensor([0, 2]))
    assert out is tpages                                   # updated in place
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    np.testing.assert_array_equal(tlogits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    written = [(3, 1), (2, 4)]                   # (page, offset) per slot
    for n in ("k", "v"):
        got = tpages[0][0][n].numpy()
        np.testing.assert_allclose(got, np.asarray(jpages[0][0][n]),
                                   atol=1e-5)
        untouched = np.ones(got.shape, bool)
        for page, off in written:
            untouched[:, page, :, off] = False
        np.testing.assert_array_equal(got[untouched], pools[n][untouched])


def test_paged_prefill_chunk_step_matches_jax():
    """A mid-page chunk crossing a page boundary: last-position logits
    within 1e-4, equal argmax, equal written pages, other pages untouched."""
    cfg, params, tree, tcfg = _weights(seed=2)
    pt, n_pages, start, C = 8, 6, 5, 6
    rng = np.random.default_rng(4)
    pools = _pools(rng, cfg, n_pages, pt)
    table = np.array([4, 1, -1, -1], np.int32)
    tokens = rng.integers(0, cfg.vocab, (1, C)).astype(np.int32)
    jlogits, jpages = jstep.make_paged_prefill_chunk_step(cfg, pt)(
        params, jnp.asarray(tokens),
        [({n: jnp.asarray(a) for n, a in pools.items()},)],
        jnp.asarray(table), jnp.asarray(start, jnp.int32))
    model = params_from_numpy(tree, tcfg)
    tpages = [({n: torch.from_numpy(a.copy()) for n, a in pools.items()},)]
    tlogits, _ = tstep.make_paged_prefill_chunk_step(tcfg, pt)(
        model, torch.from_numpy(tokens), tpages, torch.from_numpy(table),
        start)
    assert tlogits.shape == (1, cfg.vocab)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    assert int(tlogits.argmax()) == int(np.asarray(jlogits).argmax())
    for n in ("k", "v"):
        got = tpages[0][0][n].numpy()
        np.testing.assert_allclose(got, np.asarray(jpages[0][0][n]),
                                   atol=1e-5)
        for page in (0, 2, 3, 5):
            np.testing.assert_array_equal(got[:, page], pools[n][:, page])


def test_copy_page_in_place():
    pool = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    expect = pool.clone()
    expect[:, 2] = expect[:, 1]
    assert tstep.copy_page(pool, 1, 2) is pool
    assert torch.equal(pool, expect)
