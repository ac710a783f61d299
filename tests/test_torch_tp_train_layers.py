"""Training with a model axis for the other layer kinds: cross, encoder,
MLA and recurrent layers (train/step.py ``shard_state`` under the cell's
rules, models/transformer.py ``train_forward`` on a rank's shards)
against the JAX package's train step, and ``blocks.rms_norm``'s gradient
over a line of ranks.

The f32 smoke configs, cut in depth to one layer of each kind
(:data:`DEPTH`), of llama-3.2-vision-11b (a GQA and a cross layer over
stub patches), whisper-medium (its encoder's two ``enc`` layers, a
decoder self-attention and a cross layer, learned positions, layer norms
with biases, the GELU MLP), deepseek-v3-671b (a dense MLA layer and two
MLA + MoE layers, 8 experts of which the model axis takes its EP share,
a shared expert, and the MTP head over the vocabulary line, its
``next_tokens`` given), xlstm-1.3b (an mLSTM and an sLSTM) and
zamba2-1.2b (a Mamba2 layer and the weight-shared block's site), every
norm and bias perturbed (tests/test_torch_train_common.py), under the
rules of their ``train_4k`` cell, on the meshes (data 2, model 2) and
(1, 8): two steps of a global batch of 4 in 2 microbatches, AdamW at the
reference's default config, on gloo ranks spawned once a mesh. Splits
covered: on (1, 8) half a head of whisper's and llama-vision's q / k / v
and of MLA's ``w_uq`` / ``w_uk`` / ``w_uv`` / ``wo`` a rank, a quarter
of an mLSTM head (the ranks that share a head each run it), Mamba2's
fused projection and conv gathered and used apart, one expert a rank;
on (2, 2) the FSDP gather over data beside the model axis, whole heads a
rank, the sLSTM's heads split with its MLP whole.

The oracles: for llama-3.2-vision-11b, whisper-medium, xlstm-1.3b and
zamba2-1.2b the reference's ``make_train_step`` jitted on an 8-device
CPU mesh with ``Auto`` axes (one subprocess a mesh, started first:
tests/test_torch_tp_train.py ``MESH_SCRIPT``); for deepseek-v3-671b,
whose mesh step the installed JAX refuses (``_pmean_grad_safe``,
``ROADMAP.md`` §3), the reference's semantics from its meshless
functions (tests/test_torch_train_common.py ``shard_oracle``: the mean
over (microbatch, data shard) of ``value_and_grad(make_loss_fn)``, the
MoE routing each data shard alone, then ``adamw.update``). Held as
tests/test_torch_tp_train.py holds the GQA archs (``hold_steps``,
``hold_first_gradients``): every metric on every rank within 1e-5 (the
MTP loss among them), each rank's weight, m and v shards within 1e-5 of
its slices of the reference's, and each rank's gradient shards of the
first step within 1e-5, each scaled by the whole model's largest
gradient (m, v), as tests/test_torch_train_mixed.py holds these archs on
one rank, and not by its own leaf's: on one rank, with no mesh, the
port's Mamba2 ``A_log`` / ``dt_bias`` and mLSTM ``wq`` gradients already
part from the reference's by 1.3e-5 of their leaf's largest (rounding
through the exponential decays and gates), and whisper's key biases
``bk`` get no gradient in exact arithmetic (a query's logits all shift
by q·bk, which the softmax ignores), so both packages' are rounding
alone. A gradient summed over a wrong line is a factor of 2 or more on
its leaf, past this gate for any leaf above 1e-5 of the largest.

The norm: ``rms_norm`` of rows whose channels are cut over a (1, 2)
model line (on the (2, 2) mesh) gives each rank the whole row's
gradient of its channels and of its part of the scale; the sum of
squares through ``reduce_from`` alone, whose backward passes each rank
only its own channels' share of the variance's cotangent, does not.
"""
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from repro_torch import configs
from repro_torch.core import tree as tree_lib
from repro_torch.launch import specs
from repro_torch.parallel import launch
from repro_torch.parallel.mesh_jobs import (FsdpJob, NormJob, fsdp_job,
                                            norm_job, run_jobs)
from test_torch_tp_train import (MESH_SCRIPT, _read_back, hold_first_gradients,
                                 hold_steps)
from test_torch_train_common import batch, shard_oracle, weights
from repro.optim import adamw as jadamw

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("llama-3.2-vision-11b", "whisper-medium", "deepseek-v3-671b",
         "xlstm-1.3b", "zamba2-1.2b")
MESH_STEP = tuple(a for a in ARCHS if a != "deepseek-v3-671b")
MESHES = ((2, 2), (1, 8))
GA = 2
STEPS = 2
GLOBAL_BATCH = 4
TOL = tts.TOL
# the smoke configs cut in depth to one layer of each kind (the
# reference's partitioned steps compile for 4-15 s an arch; the GQA
# layers' training is tests/test_torch_tp_train.py's): llama-vision to a
# GQA and its cross layer, whisper's decoder to one unit, xlstm-1.3b to
# one mLSTM and one sLSTM (a stack of its mLSTMs also amplifies the f32
# rounding of their exponential gates past these tolerances, on one rank
# as on many), zamba2 to a Mamba2 layer and the shared block's site
DEPTH = {"llama-3.2-vision-11b": ((("gqa:mlp", "cross:mlp"), 1),),
         "whisper-medium": ((("gqa:none", "cross:mlp"), 1),),
         "xlstm-1.3b": ((("mlstm:none", "slstm:none"), 1),),
         "zamba2-1.2b": ((("mamba:none", "shared:mlp"), 1),)}
# the tied embeddings' rows no token of either step's batch reads take
# only the head's gradient, within the rounding share of the rows read:
# the [512, 64] table is 23 % of xlstm-1.3b's cut smoke model and 14 % of
# zamba2-1.2b's (granite's in tests/test_torch_tp_train.py: 5 %)
MAX_UNSETTLED = {"xlstm-1.3b": 0.1, "zamba2-1.2b": 0.1}
# an update's allowance in ulps of its weight: at the second step lr is
# 2e-2 of its peak (the warmup), one ulp of a weight near 2^-5 (the
# tied embeddings' N(0, 0.02²)) 3.1e-4 of it, each package's old weight
# may differ by an ulp already and each rounds its new one
ULPS = 4
# the leaves whose gradient is zero in exact arithmetic (whisper's key
# biases: the softmax ignores a shift of all of a query's logits)
NULL_GRADS = ("mixer/bk",)
# the rms_norm rows: [N, d], d cut in two
NORM_ROWS, NORM_WIDTH = 6, 16


def _rules(arch):
    return specs.rule_overrides(specs.cell_config(
        arch, configs.SHAPES["train_4k"], smoke=True))


def _norm_case(seed=3):
    rng = np.random.default_rng(seed)
    return NormJob(*(rng.standard_normal(shape).astype(np.float32)
                     for shape in ((NORM_ROWS, NORM_WIDTH), (NORM_WIDTH,),
                                   (NORM_ROWS, NORM_WIDTH))))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's mesh steps (one subprocess a mesh, started first),
    the port's ranks (one spawn a mesh, each in a thread: (1, 8) at once,
    (2, 2), with the norm's job, once the subprocesses end) and
    deepseek's oracles (in this process, meanwhile)."""
    d = tmp_path_factory.mktemp("tp_train_layers")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    for arch in ARCHS:                    # the batches, before the threads
        weights(arch, DEPTH.get(arch))
        for s in range(STEPS):
            batch(arch, s, GLOBAL_BATCH)
    archs = {a: (weights(a, DEPTH.get(a))[0], weights(a, DEPTH.get(a))[1],
                 [batch(a, s, GLOBAL_BATCH) for s in range(STEPS)])
             for a in MESH_STEP}
    procs = {}
    for mesh in MESHES:
        inp, outp = d / f"in{mesh}.pkl", d / f"out{mesh}.pkl"
        with open(inp, "wb") as f:
            pickle.dump(dict(mesh=mesh, archs=archs, ga=GA,
                             rules={a: _rules(a) for a in MESH_STEP}), f)
        with open(d / f"log{mesh}.txt", "w") as log:
            procs[mesh] = (subprocess.Popen(
                [sys.executable, "-c", MESH_SCRIPT, str(inp), str(outp)],
                env=env, stdout=log, stderr=subprocess.STDOUT), outp)
    ours, errors = {}, []

    def run_ranks(mesh, after=()):
        try:
            for proc, _ in after:         # the reference's passes first
                proc.wait()
            calls = []
            for arch in ARCHS:
                _, tree, tcfg = weights(arch, DEPTH.get(arch))
                calls.append((fsdp_job, FsdpJob(
                    cfg=tcfg, weights=tree, grad_accum=GA,
                    batches=[batch(arch, s, GLOBAL_BATCH)
                             for s in range(STEPS)],
                    mesh=mesh, rules=_rules(arch), wholes=False,
                    shards=True)))
            if mesh == (2, 2):
                calls.append((norm_job, _norm_case()))
            got = launch.spawn(run_jobs, mesh[0] * mesh[1], (calls,),
                               store_dir=str(d / f"store{mesh}"),
                               backend="gloo", timeout_s=300.0)
            for j, arch in enumerate(ARCHS):
                ours[(arch, mesh)] = [r[j] for r in got]
            if mesh == (2, 2):
                ours["norm"] = [r[-1] for r in got]
        except BaseException as e:        # re-raised in the fixture
            errors.append(e)

    try:
        threads = [threading.Thread(target=run_ranks, args=(MESHES[1],)),
                   threading.Thread(target=run_ranks,
                                    args=(MESHES[0], procs.values()))]
        for t in threads:
            t.start()
        oracles = {m: shard_oracle("deepseek-v3-671b", m[0], GA,
                                   steps=STEPS, global_batch=GLOBAL_BATCH)
                   for m in MESHES}
        for t in threads:
            t.join()
        ref = {}
        for mesh, (proc, outp) in procs.items():
            proc.wait(timeout=600)
            assert proc.returncode == 0, \
                (d / f"log{mesh}.txt").read_text()[-3000:]
            with open(outp, "rb") as f:
                ref[mesh] = pickle.load(f)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    if errors:
        raise errors[0]
    return ref, ours, oracles


def _reference(arch, mesh, results):
    """([(metrics, numpy state leaves)] a step, [gradient leaves] a step):
    the reference's mesh step (its gradients read back from its first
    moment), or deepseek's oracle."""
    import jax
    ref, _, oracles = results
    if arch in MESH_STEP:
        steps = ref[mesh][arch]
        return ([(m, jax.tree_util.tree_leaves(st)) for m, st in steps],
                _read_back([(m, jax.tree_util.tree_leaves(st.opt.m))
                            for m, st in steps], jadamw.Config()))
    return ([(m, jax.tree_util.tree_leaves(st)) for m, st, _ in
             oracles[mesh]], [g for _, _, g in oracles[mesh]])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_steps_equal_the_reference(arch, mesh, results):
    steps, grads = _reference(arch, mesh, results)
    ranks = results[1][(arch, mesh)]
    if arch == "deepseek-v3-671b":        # the MTP loss over the line
        assert "mtp_loss" in ranks[0]["metrics"][0]
    hold_steps(arch, mesh, ranks, steps, grads, DEPTH.get(arch),
               MAX_UNSETTLED.get(arch, tts.MAX_UNSETTLED), model_scale=True,
               null=NULL_GRADS, ulps=ULPS, propagate=True)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_first_gradient_shards_equal_the_reference(arch, mesh, results):
    want = _reference(arch, mesh, results)[1][0]
    hold_first_gradients(arch, mesh, results[1][(arch, mesh)], want,
                         DEPTH.get(arch), model_scale=True)


def _norm_grads(case, own=None):
    """The whole row's rms_norm (eps 1e-6, f32) and the gradients of
    Σ(y · cot) for x and the scale; with ``own`` (a slice of the
    channels) the variance's cotangent from those channels' terms alone,
    the others' held constant: what a rank of the line gets when the
    backward of the sum of squares is the identity."""
    x = torch.from_numpy(case.x).requires_grad_(True)
    scale = torch.from_numpy(case.scale).requires_grad_(True)
    sq = x.square()
    if own is not None:
        mine = torch.zeros_like(sq, dtype=torch.bool)
        mine[:, own] = True
        sq = torch.where(mine, sq, sq.detach())
    y = x * torch.rsqrt(sq.mean(-1, keepdim=True) + 1e-6) * scale
    keep = slice(None) if own is None else own
    (y[:, keep] * torch.from_numpy(case.cot)[:, keep]).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), scale.grad.numpy()


def test_rms_norm_gradient_over_a_line(results):
    case, ranks = _norm_case(), results[1]["norm"]
    y, dx, ds = _norm_grads(case)
    n = NORM_WIDTH // 2
    for r in ranks:
        own = slice(r["coords"]["model"] * n, (r["coords"]["model"] + 1) * n)
        np.testing.assert_allclose(r["y"], y[:, own], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["dx"], dx[:, own], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["dscale"], ds[own], rtol=1e-5,
                                   atol=1e-5)
        # reduce_from alone: the variance's cotangent of its own channels
        old = _norm_grads(case, own)[1][:, own]
        assert np.abs(old - dx[:, own]).max() > 1e-2 * np.abs(dx).max()
