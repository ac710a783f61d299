"""The training path's pieces in the port against the JAX package, on the
CPU: ``models/flash_xla.py`` (output and the gradients of q, k and v),
``train/loss.py``, ``optim/adamw.py``, ``parallel/compression.py`` and
``data/pipeline.py``.

Inputs are drawn from numpy seeds and run through both packages:

  * ``flash_attention_xla`` against JAX's ``flash_attention_xla`` and
    ``jax.grad`` of it, within 1e-5: GQA (G 2), causal, a window, a
    softcap, a ``q_offset`` past the keys, a ``kv_len_mask`` with a row
    that sees no key (the mean of V), and lengths the chunk does not
    divide; the skipped key blocks give the same numbers as the reference,
    which computes every block;
  * ``cross_entropy`` / ``lm_loss`` (with ``z_loss``, the MoE aux, MTP)
    and their gradients within 1e-5;
  * AdamW's schedule at steps 0, warmup, the end and past it, and one
    ``update`` with clipping (norm leaves stacked 2-D and decayed, 1-D
    ones not) within 1e-5;
  * the compressor's bf16 and int8 paths (a padded last block) bit for
    bit, and its error feedback;
  * ``synth_tokens`` / ``make_batch`` bit for bit, the prefetch loader.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdp
from repro.models.flash_xla import _chunks as jflash_chunks
from repro.models.flash_xla import flash_attention_xla as jflash
from repro.optim import adamw as jadamw
from repro.parallel import compression as jcomp
from repro.train import loss as jloss
from repro_torch.core import tree as tree_lib
from repro_torch.data import pipeline as tdp
from repro_torch.models import flash_xla as tflash
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import compression as tcomp
from repro_torch.train import loss as tloss

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = 1e-5


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# flash_xla
# --------------------------------------------------------------------------
CASES = {
    # name: (B, H, K, Lq, Lkv, hd, causal, window, softcap, q_chunk,
    #        kv_chunk, q_offset, mask)
    "gqa_causal": (2, 4, 2, 24, 24, 8, True, None, None, 8, 8, 0, False),
    "window": (1, 4, 2, 30, 30, 8, True, 7, None, 8, 8, 0, False),
    "softcap": (1, 2, 1, 16, 16, 8, True, None, 5.0, 4, 4, 0, False),
    "q_offset": (2, 4, 2, 8, 24, 8, True, None, None, 4, 8, 16, False),
    "kv_len_mask": (2, 4, 2, 12, 20, 8, False, None, None, 5, 7, 0, True),
    "undivided": (1, 4, 2, 13, 13, 8, True, 3, 2.0, 5, 5, 0, True),
    "no_key_by_position": (1, 2, 1, 8, 8, 8, True, 2, None, 4, 4, 20,
                           False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_xla_output_and_grads_equal_jax(case):
    (B, H, K, Lq, Lkv, hd, causal, window, softcap, qc, kc, off,
     masked) = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = rng.standard_normal((B, H, Lq, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, Lkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, Lkv, hd)).astype(np.float32)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((B, Lkv)) < 0.7
        mask[0] = False                       # a row that sees no key
    args = (causal, window, softcap, qc, kc)
    jmask = None if mask is None else jnp.asarray(mask)
    jout = jflash(q, k, v, *args, off, jmask)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(
        jflash(a, b, c, *args, off, jmask) * dout), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = tflash.flash_attention_xla(
        tq, tk, tv, *args, off, None if mask is None else torch.from_numpy(mask))
    (tout * torch.from_numpy(dout)).sum().backward()
    close(tout, jout)
    for t, g in zip((tq, tk, tv), jgrads):
        close(t.grad, g)


@pytest.mark.parametrize("L", [1, 7, 13, 24, 30, 4096])
def test_flash_xla_chunks_equal_the_reference(L):
    """The blocks tile the axis as the reference's do: the largest chunk
    ≤ c that divides L."""
    for c in (1, 3, 5, 8, 512, 5000):
        assert tflash._chunks(L, c) == jflash_chunks(L, c)


def test_flash_xla_saves_only_out_and_lse():
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    k = torch.randn(1, 1, 16, 8, requires_grad=True)
    v = torch.randn(1, 1, 16, 8, requires_grad=True)
    out = tflash.flash_attention_xla(q, k, v, True, None, None, 4, 4)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (1, 2, 16, 8), (1, 1, 16, 8), (1, 1, 16, 8), (1, 2, 16, 8),
        (1, 1, 2, 16)]


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_and_lm_loss_equal_jax(z_loss):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    mtp = rng.standard_normal((2, 5, 33)).astype(np.float32)
    mtp_labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    jl, jm = jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 z_loss)
    tl, tm = tloss.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), z_loss)
    close(tl, jl)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        close(tm[k], jm[k])
    aux = {"moe_aux": np.float32(0.25), "mtp_logits": mtp,
           "mtp_labels": mtp_labels}

    def jfn(lg, mt):
        a = dict(aux, mtp_logits=mt)
        return jloss.lm_loss(lg, jnp.asarray(labels), a, mtp_weight=0.3,
                             z_loss=z_loss)[0]

    jv, (jg, jgm) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(mtp))
    tlg = torch.tensor(logits, requires_grad=True)
    tmt = torch.tensor(mtp, requires_grad=True)
    tv, tmets = tloss.lm_loss(tlg, torch.from_numpy(labels), {
        "moe_aux": torch.tensor(0.25), "mtp_logits": tmt,
        "mtp_labels": torch.from_numpy(mtp_labels)}, mtp_weight=0.3,
        z_loss=z_loss)
    tv.backward()
    close(tv, jv)
    close(tlg.grad, jg)
    close(tmt.grad, jgm)
    assert sorted(tmets) == sorted(
        ["nll", "ppl_log", "moe_aux", "mtp_loss", "loss"]
        + (["z_loss"] if z_loss else []))


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 50, 99, 100, 5000, 9999, 10000, 20000])
def test_schedule_equals_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10000,
               min_lr_ratio=0.1)
    ref = jadamw.schedule(jnp.asarray(step, jnp.int32), jadamw.Config(**cfg))
    got = tadamw.schedule(torch.tensor(step, dtype=torch.int32),
                          tadamw.Config(**cfg))
    close(got, ref, tol=1e-7)


def _opt_tree(rng):
    """A parameter tree with the shapes AdamW treats apart: stacked 2-D
    norm scales and matrices (decayed), a 1-D final norm and a bias (not)."""
    return {"embed": rng.standard_normal((11, 6)).astype(np.float32),
            "final_norm": {"scale": np.ones(6, np.float32)},
            "groups": [({"ln1": {"scale": (1 + 0.1 * rng.standard_normal(
                (2, 6))).astype(np.float32)},
                "mixer": {"wq": rng.standard_normal((2, 6, 6)).astype(
                    np.float32), "bq": rng.standard_normal((2, 6)).astype(
                    np.float32)}},)],
            "bias": rng.standard_normal(6).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_equals_jax(clip):
    rng = np.random.default_rng(4)
    params = _opt_tree(rng)
    grads = tree_lib.tree_map(
        lambda p: (3 * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    m = tree_lib.tree_map(
        lambda p: (0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    v = tree_lib.tree_map(
        lambda p: np.abs(0.1 * rng.standard_normal(p.shape)).astype(
            np.float32), params)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip)
    jp, jo, jmets = jadamw.update(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jadamw.OptState(jax.tree_util.tree_map(jnp.asarray, m),
                        jax.tree_util.tree_map(jnp.asarray, v)),
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(5, jnp.int32), jadamw.Config(**cfg))
    t = lambda tree: tree_lib.tree_map(torch.from_numpy, tree)  # noqa: E731
    tp, to, tmets = tadamw.update(t(grads), tadamw.OptState(t(m), t(v)),
                                  t(params), torch.tensor(5, dtype=torch.int32),
                                  tadamw.Config(**cfg))
    for k in ("grad_norm", "lr"):
        close(tmets[k], jmets[k])
    if clip:
        assert float(jmets["grad_norm"]) > clip          # clipping engaged
    for ref, got in ((jp, tp), (jo.m, to.m), (jo.v, to.v)):
        jl = jax.tree_util.tree_flatten_with_path(ref)[0]
        tl = tree_lib.paths(got)
        assert len(jl) == len(tl)
        for (_, a), (key, b) in zip(jl, tl):
            close(b, a)
    # decay: a 2-D stacked norm scale moves by its decay term, the 1-D
    # final norm (zero decay term) by Adam's step alone
    assert tp["groups"][0][0]["ln1"]["scale"].dim() == 2


def test_adamw_init_and_none_grads():
    params = {"a": torch.ones(2, 3), "b": torch.ones(3)}
    opt = tadamw.init(params)
    assert all(x.dtype == torch.float32 and not x.any()
               for x in tree_lib.leaves(opt))
    new, opt2, mets = tadamw.update({"a": torch.ones(2, 3), "b": None}, opt,
                                    params, torch.tensor(0),
                                    tadamw.Config(lr=1.0, warmup_steps=1))
    # b had no gradient: no Adam step, and 1-D, so no decay either
    assert torch.equal(new["b"], params["b"])
    assert float(mets["grad_norm"]) == pytest.approx(6 ** 0.5)


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compressor_equals_jax_bit_for_bit(mode):
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((7, 100)).astype(np.float32),
            "b": (1e-3 * rng.standard_normal(300)).astype(np.float32),
            "z": np.zeros((3, 3), np.float32)}
    ref = jcomp.Compressor(mode=mode)(jax.tree_util.tree_map(jnp.asarray,
                                                             tree))
    got = tcomp.Compressor(mode=mode)(tree_lib.tree_map(torch.from_numpy,
                                                        tree))
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    if mode == "int8":      # 700 and 300 elements: padded last blocks
        q, s = tcomp.quantize_int8(torch.from_numpy(tree["w"]), 256)
        jq, js = jcomp.quantize_int8(jnp.asarray(tree["w"]), 256)
        assert q.shape == (3, 256) and q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_error_feedback_equals_jax():
    rng = np.random.default_rng(6)
    g = {"w": rng.standard_normal((5, 60)).astype(np.float32)}
    r = {"w": (0.01 * rng.standard_normal((5, 60))).astype(np.float32)}
    jout, jres = jcomp.with_error_feedback(
        jcomp.Compressor(mode="int8", block=64),
        jax.tree_util.tree_map(jnp.asarray, g),
        jax.tree_util.tree_map(jnp.asarray, r))
    tout, tres = tcomp.with_error_feedback(
        tcomp.Compressor(mode="int8", block=64),
        tree_lib.tree_map(torch.from_numpy, g),
        tree_lib.tree_map(torch.from_numpy, r))
    np.testing.assert_array_equal(tout["w"].numpy(), np.asarray(jout["w"]))
    np.testing.assert_array_equal(tres["w"].numpy(), np.asarray(jres["w"]))
    assert not tcomp.init_residual({"w": torch.ones(2)})["w"].any()


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mtp", [False, True])
def test_make_batch_bit_for_bit(mtp):
    kw = dict(vocab=151936, seq_len=33, global_batch=6, seed=7, mtp=mtp)
    for step in (0, 1, 12345):
        ref = jdp.make_batch(jdp.DataConfig(**kw), step)
        got = tdp.make_batch(tdp.DataConfig(**kw), step)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
    sharded = dict(kw, n_hosts=2, host_id=1)
    np.testing.assert_array_equal(
        tdp.synth_tokens(tdp.DataConfig(**sharded), 3),
        jdp.synth_tokens(jdp.DataConfig(**sharded), 3))


def test_prefetch_loader_puts_batches_on_the_device_in_order():
    cfg = tdp.DataConfig(vocab=50, seq_len=8, global_batch=2)
    loader = tdp.PrefetchLoader(cfg, start_step=4, device="cpu")
    try:
        for want in (4, 5, 6):
            step, b = next(loader)
            assert step == want and isinstance(b["tokens"], torch.Tensor)
            np.testing.assert_array_equal(b["tokens"].numpy(),
                                          tdp.make_batch(cfg, want)["tokens"])
    finally:
        loader.stop()
    gen = tdp.make_batches(cfg, 2)
    np.testing.assert_array_equal(next(gen)["labels"],
                                  tdp.make_batch(cfg, 2)["labels"])


# --------------------------------------------------------------------------
# isolation
# --------------------------------------------------------------------------
TRAIN_MODULES = ("repro_torch.launch.train", "repro_torch.train.step",
                 "repro_torch.train.loss", "repro_torch.optim.adamw",
                 "repro_torch.models.flash_xla", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.manager",
                 "repro_torch.parallel.compression", "repro_torch.core.tree")


def test_training_modules_import_no_jax_and_the_driver_needs_a_card(
        tmp_path):
    code = ("import importlib, sys\n"
            f"for m in {TRAIN_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ISOLATED')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=SRC, env=env)
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--smoke", "--steps", "1", "--ckpt-dir",
                        str(tmp_path)], capture_output=True,
                       text=True, timeout=120, cwd=SRC, env=env)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr
