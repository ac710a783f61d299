"""Shared set-up of the train-mode tests (no tests of its own): the
reference's weights for an arch's f32 smoke config, carried into the
port, a batch, and the JAX functions the port is held against, each
jitted once a process (``jax.jit`` of a train-mode forward or its
``value_and_grad`` costs seconds an arch on the CPU)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jdp
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.models.convert import params_from_numpy

# leaves drawn as constants (norm scales and biases, Mamba2's D and
# dt_bias): moved by N(0, 0.1²) so that the tests see them
PERTURBED = ("scale", "bias", "q_norm", "kv_norm", "norm", "bq", "bk", "bv",
             "b_in", "b_out", "D", "dt_bias")
BATCH, SEQ = 2, 16
# xlstm-1.3b's exponential input gates (up to e^12) amplify f32 rounding:
# its serving tests hold logits at 1e-4 too (tests/test_torch_xlstm.py)
TOL = {"xlstm-1.3b": 1e-4}


def tol(arch: str) -> float:
    return TOL.get(arch, 1e-5)


def close_scaled(got, ref, tol: float, scale=None):
    """|got − ref| ≤ tol·|ref| + tol·scale elementwise (scale: the largest
    |ref| by default)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


@functools.lru_cache(maxsize=None)
def weights(arch: str, groups=None):
    """(jax cfg, numpy tree, port cfg): the f32 smoke config's
    ``PRNGKey(0)`` weights, :data:`PERTURBED` leaves moved; ``groups``:
    the config's layer groups replaced (a cut in depth)."""
    over = {} if groups is None else {"groups": groups}
    cfg = jconfigs.get_smoke_config(arch, compute_dtype=jnp.float32, **over)
    tree = jax.tree_util.tree_map(np.array, jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0])
    rng = np.random.default_rng(1)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", ""))
        if name in PERTURBED:
            leaf = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        leaves.append(leaf)
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    tcfg = tconfigs.get_smoke_config(arch, compute_dtype=torch.float32,
                                     **over)
    return cfg, tree, tcfg


def model(arch: str, **overrides):
    """A fresh port model on the CPU from :func:`weights`."""
    _, tree, tcfg = weights(arch)
    return params_from_numpy(tree, dataclasses.replace(tcfg, **overrides))


@functools.lru_cache(maxsize=None)
def batch(arch: str, step: int = 0, global_batch: int = BATCH):
    """make_batch at the smoke vocabulary (MTP targets for deepseek), and
    stub encoder input ``extra`` for the cross-attention archs."""
    cfg = weights(arch)[0]
    b = jdp.make_batch(jdp.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=global_batch,
                                      mtp=cfg.mtp), step)
    if cfg.family in ("vlm", "audio"):
        rng = np.random.default_rng(2 + step)
        b["extra"] = rng.standard_normal(
            (global_batch, cfg.encoder_seq, cfg.cross_kv_dim or cfg.d_model)
        ).astype(np.float32)
    return b


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def jax_forward(arch: str):
    """jit of the reference's ``forward(mode="train")`` → (logits, aux)."""
    cfg = weights(arch)[0]

    def f(params, b):
        logits, _, aux = jtransformer.forward(
            params, b["tokens"], cfg, extra=b.get("extra"), mode="train",
            next_tokens=b.get("next_tokens"))
        return logits, aux
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(arch: str, groups=None):
    """jit of ``jax.value_and_grad(make_loss_fn(cfg), has_aux=True)``."""
    cfg = weights(arch, groups)[0]
    return jax.jit(jax.value_and_grad(jstep.make_loss_fn(cfg), has_aux=True))


def jax_params(arch: str, groups=None):
    return jax.tree_util.tree_map(jnp.asarray, weights(arch, groups)[1])


def shard_oracle(arch: str, data: int, grad_accum: int, compress=None,
                 groups=None, steps: int = 2, global_batch: int = 4):
    """The reference's train step on a mesh of ``data`` data shards from
    its meshless functions (its mesh step refuses the MoE archs:
    ``ROADMAP.md`` §3): per step the mean over (microbatch, shard) of
    ``value_and_grad(make_loss_fn)`` on each shard's rows and of its
    metrics (the MoE routes each shard alone, as the reference's
    ``shard_map`` does), the compressor (``compress``), then
    ``adamw.update`` → [(metrics, numpy state, the gradient's numpy
    leaves before the compressor)] a step, from :func:`weights` (at
    ``groups``) and :func:`batch`."""
    from repro.optim import adamw as jadamw
    from repro.parallel import compression as jcomp
    vg = jax_value_and_grad(arch, groups)
    params = jax_params(arch, groups)
    update = jax.jit(jadamw.update, static_argnums=4)
    state = jstep.TrainState(params=params, opt=jadamw.init(params),
                             step=jnp.zeros((), jnp.int32))
    out = []
    for s in range(steps):
        b = batch(arch, s, global_batch)
        mb = global_batch // grad_accum
        part = mb // data
        grads, mets = [], []
        for m in range(grad_accum):
            for r in range(data):
                rows = slice(m * mb + r * part, m * mb + (r + 1) * part)
                (_, met), g = vg(state.params, jax_batch(
                    {k: v[rows] for k, v in b.items()}))
                grads.append(jax.tree_util.tree_leaves(g))
                mets.append(met)
        flat = [sum(np.asarray(x) for x in gs) / len(gs)
                for gs in zip(*grads)]
        g = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(state.params),
            [jnp.asarray(x) for x in flat])
        if compress:
            g = jcomp.Compressor(mode=compress)(g)
        new_p, new_opt, om = update(g, state.opt, state.params, state.step,
                                    jadamw.Config())
        metrics = {k: float(np.mean([float(m[k]) for m in mets]))
                   for k in mets[0]}
        metrics.update({k: float(v) for k, v in om.items()},
                       tokens=float(b["tokens"].size))
        state = jstep.TrainState(params=new_p, opt=new_opt,
                                 step=state.step + 1)
        out.append((metrics, jax.tree_util.tree_map(np.asarray, state),
                    flat))
    return out

