"""FSDP data-parallel training on 2 ranks against the JAX package.

The reference's train driver puts its state on a (devices, 1) mesh under
``tree_shardings`` (``embed_fsdp`` over ``data``) and its jitted step
splits each microbatch's rows over ``data``; the MoE routes each
(microbatch, shard) alone (its ``shard_map`` over the batch axes). The
port's FSDP step (train/step.py ``shard_state``, ``rank_rows``) runs on 2
gloo ranks, spawned once for the file (repro_torch/parallel/mesh_jobs.py), from
the f32 smoke weights of tests/test_torch_train_common.py:

  * qwen2-0.5b (``grad_accum`` 2, the int8 compressor), granite-moe-3b-
    a800m and deepseek-v3-671b (``grad_accum`` 2): two steps held at the
    tolerances of tests/test_torch_train_step.py (every metric, weight
    and moment within 1e-5; each element's change over a step within
    1e-4 of lr, m and v within 1e-5 of each leaf's largest, but for the
    elements whose step the rounding decides) against the reference's
    step. For qwen2 that is JAX's ``make_train_step`` jitted under a (2,
    1) ``Auto`` mesh (a subprocess with 2 host devices). For the MoE archs
    the reference's mesh step raises on the installed JAX (its
    ``_pmean_grad_safe`` returns an invariant cotangent for a varying
    input; pinned here, ``ROADMAP.md`` §3), so they are held against the
    reference's own semantics built from its meshless functions: the mean
    over (microbatch, shard) of ``value_and_grad(make_loss_fn)`` on each
    shard's rows, then its compressor and ``adamw.update``. For qwen2 that
    construction equals the mesh step within 1e-5 (held too).
  * Checkpoints: a checkpoint the 2 ranks write (rank 0, whole leaves)
    restores in a 1-rank port state and in JAX's manager bit for bit; a
    checkpoint JAX's manager writes restores on the 2 ranks, each taking
    its slice, whose gathered leaves equal JAX's bit for bit.
  * The driver: ``train`` on 2 ranks (``--ranks 2``'s path) with an
    injected failure gives the 1-rank run's losses within 1e-5 and its
    final weights within 1e-5; the CLI with ``--ranks 2`` rolls back and
    finishes, and a later 1-rank run resumes from its checkpoint.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as tts
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import tree as tree_lib
from repro_torch.launch import train as ttrain
from repro_torch.parallel import launch
from repro_torch.train import step as tstep
from repro_torch.parallel.mesh_jobs import (FsdpJob, TrainJob, each,
                                            fsdp_job, train_job)
from test_torch_train_common import (batch, jax_batch, jax_params, model,
                                     shard_oracle, weights)

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
RANKS = 2
CASES = {"qwen2-0.5b": dict(grad_accum=2, compress="int8"),
         "granite-moe-3b-a800m": dict(grad_accum=2, compress=None),
         "deepseek-v3-671b": dict(grad_accum=2, compress=None)}
TOL = tts.TOL
# granite's tied embedding: the rows no token of a shard's batch reads get
# the head's gradient alone, below 1e-4 of the leaf's largest (7 % of its
# elements, 2.2 % of all after one step, 3.6 % after two); the update check
# leaves such elements out (tests/test_torch_train_step.py ``unsettled``)
# and the weight and moment checks hold them all the same
MAX_UNSETTLED = {"granite-moe-3b-a800m": 0.05}

MESH_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from repro.models import blocks, transformer
from repro.optim import adamw
from repro.parallel import compression, sharding as shlib
from repro.train import step as jstep
from test_torch_train_common import batch, jax_batch, weights

auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 1), ("data", "model"), axis_types=(auto, auto))
out = {}
for arch, comp in (("qwen2-0.5b", "int8"), ("granite-moe-3b-a800m", None)):
    cfg, tree, _ = weights(arch)
    axes = blocks.split_params(jax.eval_shape(
        lambda: transformer.init_model(jax.random.PRNGKey(0), cfg)))[1]
    with shlib.use_mesh(mesh):
        sh = shlib.tree_shardings(axes, jax.tree_util.tree_map(
            lambda x: tuple(x.shape), tree), mesh)
        params = jax.tree_util.tree_map(jax.device_put, tree, sh)
        state = jstep.TrainState(params=params, opt=adamw.init(params),
                                 step=jnp.zeros((), jnp.int32))
        ts = jax.jit(jstep.make_train_step(
            cfg, adamw.Config(), grad_accum=2,
            compressor=comp and compression.Compressor(mode=comp)))
        try:
            steps = []
            for s in range(2):
                state, m = ts(state, jax_batch(batch(arch, s, 4)))
                steps.append(({k: float(v) for k, v in m.items()},
                              jax.tree_util.tree_map(np.asarray, state)))
            out[arch] = steps
        except ValueError as e:
            out[arch] = str(e)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """JAX's mesh train steps, started first (a subprocess)."""
    path = tmp_path_factory.mktemp("jax_mesh") / "out.pkl"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", MESH_SCRIPT, str(path),
                             str(TESTS)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()


def _jax_mesh_result(jax_mesh):
    proc, path = jax_mesh
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out + err[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _jax_state_after_one_step(arch):
    cfg = weights(arch)[0]
    params = jax_params(arch)
    state = jstep.TrainState(params=params, opt=jadamw.init(params),
                             step=jnp.zeros((), jnp.int32))
    return jax.jit(jstep.make_train_step(cfg, jadamw.Config()))(
        state, jax_batch(batch(arch)))[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every port case on the same 2 gloo ranks: the three archs' two
    steps, a step saved to ``two/``, and a JAX checkpoint of ``jax/``
    restored (no step)."""
    d = tmp_path_factory.mktemp("fsdp")
    JManager(str(d / "jax")).save(1, _jax_state_after_one_step(
        "qwen2-0.5b"), extra={"data_step": 1})
    jobs = []
    for arch, case in CASES.items():
        _, tree, tcfg = weights(arch)
        jobs.append(FsdpJob(cfg=tcfg, weights=tree,
                            batches=[batch(arch, s, 4) for s in range(2)],
                            grad_accum=case["grad_accum"],
                            compress=case["compress"]))
    _, tree, tcfg = weights("qwen2-0.5b")
    jobs.append(FsdpJob(cfg=tcfg, weights=tree, batches=[batch("qwen2-0.5b")],
                        save_dir=str(d / "two")))
    jobs.append(FsdpJob(cfg=tcfg, weights=tree, batches=[],
                        restore_dir=str(d / "jax")))
    out = launch.spawn(each, RANKS, (fsdp_job, jobs),
                       store_dir=str(d / "store"), backend="gloo",
                       timeout_s=300.0)
    return d, [list(r) for r in zip(*out)]   # per job: each rank's result


@functools.lru_cache(maxsize=None)
def _oracle(arch):
    """The reference's semantics on a (2, 1) mesh from its meshless
    functions (test_torch_train_common.py ``shard_oracle``)."""
    case = CASES[arch]
    return shard_oracle(arch, RANKS, case["grad_accum"], case["compress"])


def _check_steps(arch, case, got, ref):
    """``got``: the ranks' results of one case; ``ref``: [(metrics, JAX
    state, the gradient before the compressor)] a step (the update check
    of tests/test_torch_train_step.py; ``grad`` None skips it)."""
    assert all(r["metrics"] == got[0]["metrics"] for r in got)
    wholes = got[0]["wholes"]
    flagged = None
    j_old = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, jax_params(arch)))
    for s, (jm, jstate, grad) in enumerate(ref):
        tm = got[0]["metrics"][s]
        assert sorted(tm) == sorted(jm)
        for k in jm:
            tts.close(np.float32(tm[k]), jm[k])
        ours = wholes[s + 1]
        assert int(ours.step) == s + 1
        for part in ("params", "opt"):
            refl = jax.tree_util.tree_flatten_with_path(getattr(jstate,
                                                                part))[0]
            gotl = tree_lib.paths(getattr(ours, part))
            assert len(refl) == len(gotl)
            for (_, a), (_, t) in zip(refl, gotl):
                tts.close(t, a)
        if grad is None:
            continue
        now = [tts.unsettled(g, case["compress"]) for g in grad]
        flagged = now if flagged is None else [a | c for a, c in
                                               zip(flagged, now)]
        n_out = sum(int(f.sum()) for f in flagged)
        assert n_out <= MAX_UNSETTLED.get(arch, tts.MAX_UNSETTLED) * sum(
            f.size for f in flagged), n_out
        lr = jm["lr"]
        t_old = tree_lib.leaves(wholes[s].params)
        j_new = jax.tree_util.tree_leaves(jstate.params)
        for t0, t1, a0, a1, keep in zip(t_old, tree_lib.leaves(ours.params),
                                        j_old, j_new,
                                        [~f for f in flagged]):
            err = np.abs((t1 - t0) - (a1 - a0))
            assert (err <= tts.UPDATE_TOL * lr
                    + 2 * np.spacing(np.abs(a1)))[keep].all(), (arch, s)
        for part in ("m", "v"):
            for t, a, keep in zip(tree_lib.leaves(getattr(ours.opt, part)),
                                  jax.tree_util.tree_leaves(
                                      getattr(jstate.opt, part)),
                                  [~f for f in flagged]):
                scale = float(np.abs(a).max())
                assert (np.abs(t - a) <= TOL * (np.abs(a) + scale))[
                    keep].all(), (arch, part, s)
        j_old = j_new


@pytest.mark.parametrize("arch", sorted(CASES))
def test_two_fsdp_steps_equal_the_reference(arch, ranks):
    _, results = ranks
    got = results[list(CASES).index(arch)]
    _check_steps(arch, CASES[arch], got, _oracle(arch))
    # every weight leaf whose embed_fsdp dimension divides is cut in two
    whole = [tuple(np.shape(a)) for a in tree_lib.leaves(
        got[0]["wholes"][0].params)]
    cut = [a != b for a, b in zip(whole, got[0]["shapes"])]
    assert any(cut) and not all(cut)
    assert got[0]["shapes"] == got[1]["shapes"]


def test_the_oracle_is_the_reference_mesh_step(jax_mesh):
    """Where the reference's mesh step runs (qwen2), the construction the
    MoE archs are held against equals it; where it does not (granite),
    its fault is pinned."""
    out = _jax_mesh_result(jax_mesh)
    for (om, ostate, _), (mm, mstate) in zip(_oracle("qwen2-0.5b"),
                                             out["qwen2-0.5b"]):
        for k in mm:
            tts.close(np.float32(om[k]), mm[k])
        for a, b in zip(jax.tree_util.tree_leaves(ostate),
                        jax.tree_util.tree_leaves(mstate)):
            tts.close(a, b)
    assert "Custom VJP bwd rule" in out["granite-moe-3b-a800m"]


def test_a_two_rank_checkpoint_restores_at_one_rank_and_in_jax(ranks):
    d, results = ranks
    saved = results[len(CASES)][0]["wholes"][-1]
    mgr = CheckpointManager(str(d / "two"))
    assert mgr.latest_step() == 1
    state = tstep.init_state(model("qwen2-0.5b"))
    host, extra = mgr.restore(tstep.state_tree(state))
    tstep.load_state(state, host)
    assert extra == {"data_step": 1}
    for a, t in zip(tree_lib.leaves(saved),
                    tree_lib.leaves(tstep.state_tree(state))):
        np.testing.assert_array_equal(t.detach().numpy(), a)
    template = _jax_state_after_one_step("qwen2-0.5b")
    restored, _ = JManager(str(d / "two")).restore(template)
    for a, b in zip(tree_lib.leaves(saved),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(b), a)


def test_a_jax_checkpoint_restores_on_two_ranks(ranks):
    _, results = ranks
    got = results[len(CASES) + 1]
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, _jax_state_after_one_step("qwen2-0.5b")))
    whole = got[0]["wholes"][0]
    assert int(whole.step) == 1
    for a, b in zip(tree_lib.leaves(whole), want):
        np.testing.assert_array_equal(a, b)


def test_the_driver_on_two_ranks_equals_one_rank(tmp_path, monkeypatch):
    """``train`` on 2 ranks (the path of ``--ranks 2``) against 1 rank, at
    the f32 smoke config, with a failure injected at step 5."""
    kw = dict(arch="qwen2-0.5b", smoke=True, steps_total=8, batch=4, seq=8,
              lr=1e-3, ckpt_every=3, inject_failure=5, device="cpu")
    tget = ttrain.configs.get_smoke_config
    monkeypatch.setattr(ttrain.configs, "get_smoke_config",
                        lambda arch: tget(arch, compute_dtype=torch.float32))
    one = ttrain.train(ckpt_dir=str(tmp_path / "one"), **kw)
    out = launch.spawn(train_job, 2, (TrainJob(
        kwargs=dict(kw, ckpt_dir=str(tmp_path / "two")), f32=True),),
        store_dir=str(tmp_path / "store"), backend="gloo", timeout_s=300.0)
    two = out[0]["losses"]
    assert out[1]["losses"] == two
    # 8 steps and the 2 replayed after the rollback to step 3
    assert len(one) == len(two) == 10
    np.testing.assert_allclose(two, one, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(two[3:5], two[5:7], rtol=1e-6)
    a, b = (CheckpointManager(str(tmp_path / n)) for n in ("one", "two"))
    assert a.latest_step() == b.latest_step() == 8
    tree = tstep.state_tree(tstep.init_state(model("qwen2-0.5b")))
    for x, y in zip(tree_lib.leaves(a.restore(tree)[0]),
                    tree_lib.leaves(b.restore(tree)[0])):
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5)


def test_the_driver_cli_with_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))

    def cmd(steps, n, *more):
        return [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                "--device", "cpu", "--steps", str(steps), "--batch", "4",
                "--seq", "8", "--ckpt-every", "2", "--ranks", str(n),
                "--ckpt-dir", str(tmp_path), *more]

    r = subprocess.run(cmd(4, 2, "--inject-failure", "3"),
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert r.stdout.count("[train] FAILURE at step 3") == 1     # rank 0
    assert "[train] resumed at step 2" in r.stdout
    assert "[train] done: 4 steps" in r.stdout
    r = subprocess.run(cmd(6, 1), capture_output=True, text=True,
                       timeout=300, env=env)
    assert "[train] restored step 4" in r.stdout, r.stdout + r.stderr
    assert "[train] done: 6 steps" in r.stdout
