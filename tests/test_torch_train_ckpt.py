"""Checkpoints and the training driver, the port against the JAX package.

  * A checkpoint the reference's ``CheckpointManager`` writes of a JAX
    ``TrainState`` (after one step, so the moments are not zero)
    restores in the port bit for bit, and one the port writes restores in
    the reference bit for bit; both write the same manifest keys to the
    same shard files.
  * The port's manager: a step directory without a manifest (a save cut
    short) is ignored, ``keep`` holds, a shape mismatch raises, an async
    save lands after ``wait``, a given step restores.
  * The port's driver (``launch/train.py``) on the CPU against the
    reference's ``train()``, both at qwen2-0.5b's smoke config in f32 from
    the reference's ``PRNGKey(0)`` weights: a restart resumes at the saved
    step and runs only the steps left, and ``--inject-failure`` rolls back
    to the last checkpoint and finishes at the last step; the losses of
    both drivers agree within 1e-4. The reference's driver runs with
    ``jax.make_mesh`` patched, in this test only, to give ``Auto`` axes
    (with the installed JAX's default ``Explicit`` axes its sharding
    refuses the mesh: ``ROADMAP.md`` §3).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.launch import train as jtrain
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint.manager import MANIFEST, CheckpointManager
from repro_torch.core import tree as tree_lib
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep
from test_torch_train_common import (batch, jax_batch, jax_params, model,
                                     torch_batch, weights)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "qwen2-0.5b"


def _jax_state_after_one_step():
    cfg = weights(ARCH)[0]
    params = jax_params(ARCH)
    state = jstep.TrainState(params=params, opt=jadamw.init(params),
                             step=jnp.zeros((), jnp.int32))
    return jax.jit(jstep.make_train_step(cfg, jadamw.Config()))(
        state, jax_batch(batch(ARCH)))[0]


def _port_state_after_one_step():
    state = tstep.init_state(model(ARCH))
    return tstep.make_train_step(weights(ARCH)[2], tadamw.Config())(
        state, torch_batch(batch(ARCH)))[0]


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", MANIFEST)) as f:
        return json.load(f)


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state_after_one_step()
    JManager(str(tmp_path)).save(1, jstate, extra={"data_step": 1})
    state = tstep.init_state(model(ARCH))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    host, extra = mgr.restore(tstep.state_tree(state))
    tstep.load_state(state, host)
    assert extra == {"data_step": 1} and int(state.step) == 1
    ref = jax.tree_util.tree_flatten_with_path(jstate)[0]
    got = tree_lib.paths(tstep.state_tree(state))
    assert [k for k, _ in got] == [
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        for path, _ in ref]
    assert len(got) == 43 and got[-1][0] == ".step"
    for (_, a), (key, t) in zip(ref, got):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(a),
                                      err_msg=key)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _port_state_after_one_step()
    CheckpointManager(str(tmp_path / "port")).save(
        1, tstep.state_tree(state), extra={"data_step": 1})
    template = _jax_state_after_one_step()
    restored, extra = JManager(str(tmp_path / "port")).restore(template)
    assert extra == {"data_step": 1}
    for (key, t), a in zip(tree_lib.paths(tstep.state_tree(state)),
                           jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), t.detach().numpy(),
                                      err_msg=key)
    # the same keys in the same shard files, shapes and dtypes
    JManager(str(tmp_path / "ref")).save(1, template)
    ours = _manifest(tmp_path / "port", 1)["leaves"]
    theirs = _manifest(tmp_path / "ref", 1)["leaves"]
    assert ours == theirs


def test_manager_ignores_partial_saves_keeps_and_checks_shapes(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(4)],
            "s": torch.tensor(3, dtype=torch.int32)}
    for s in (1, 2, 3):
        mgr.save(s, tree, extra={"data_step": s}, blocking=False)
    mgr.wait()
    assert mgr.list_steps() == [2, 3]                      # keep = 2
    os.makedirs(os.path.join(d, "step_00000009"))          # cut short
    np.save(os.path.join(d, "step_00000009", "shard_00000.npy"), np.ones(1))
    assert mgr.latest_step() == 3
    host, extra = mgr.restore(tree)
    assert extra == {"data_step": 3}
    np.testing.assert_array_equal(host["a"], tree["a"].numpy())
    assert host["s"].dtype == np.int32 and host["s"].shape == ()
    assert mgr.restore(tree, step=2)[1] == {"data_step": 2}
    with pytest.raises(ValueError, match="shape mismatch for a"):
        mgr.restore(dict(tree, a=torch.zeros(3, 2)))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


# --------------------------------------------------------------------------
# the drivers
# --------------------------------------------------------------------------
@pytest.fixture
def same_start(monkeypatch):
    """Both drivers at the f32 smoke config from the reference's weights
    (the reference's mesh built with Auto axes)."""
    make_mesh = jax.make_mesh
    auto = jax.sharding.AxisType.Auto
    monkeypatch.setattr(jax, "make_mesh", lambda shape, names, **kw: make_mesh(
        shape, names, axis_types=(auto,) * len(names), **kw))
    get = jtrain.configs.get_smoke_config
    monkeypatch.setattr(jtrain.configs, "get_smoke_config",
                        lambda arch: get(arch, compute_dtype=jnp.float32))
    tget = ttrain.configs.get_smoke_config
    monkeypatch.setattr(ttrain.configs, "get_smoke_config",
                        lambda arch: tget(arch, compute_dtype=torch.float32))
    jcfg = weights(ARCH)[0]

    def build_state(cfg, seed, device):
        tree = jax.tree_util.tree_map(np.array, jblocks.split_params(
            jtransformer.init_model(jax.random.PRNGKey(seed), jcfg))[0])
        return tstep.init_state(params_from_numpy(tree, cfg, device))

    monkeypatch.setattr(ttrain, "build_state", build_state)


def _both(tmp_path, **kw):
    ref = jtrain.train(ARCH, smoke=True, ckpt_dir=str(tmp_path / "jax"),
                       batch=4, seq=16, lr=1e-3, **kw)
    ours = ttrain.train(ARCH, True, ckpt_dir=str(tmp_path / "torch"),
                        batch=4, seq=16, lr=1e-3, device="cpu", **kw)
    return ref, ours


def test_driver_restart_resumes_as_the_reference(tmp_path, same_start):
    first = _both(tmp_path, steps_total=6, ckpt_every=3)
    ref, ours = _both(tmp_path, steps_total=9, ckpt_every=3)
    assert len(ref) == len(ours) == 3             # only steps 6..9 run
    np.testing.assert_allclose(first[1], first[0], rtol=1e-4)
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    assert CheckpointManager(str(tmp_path / "torch")).latest_step() == 9
    assert _manifest(tmp_path / "torch", 9)["extra"] == {"data_step": 9}


def test_driver_rolls_back_an_injected_failure_as_the_reference(
        tmp_path, same_start):
    ref, ours = _both(tmp_path, steps_total=12, ckpt_every=5,
                      inject_failure=8)
    # 12 steps and the 3 replayed after the rollback to step 5
    assert len(ref) == len(ours) == 15 and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    np.testing.assert_allclose(ours[5:8], ours[8:11], rtol=1e-6)
    assert CheckpointManager(str(tmp_path / "torch")).latest_step() == 12


def test_driver_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))

    def cmd(steps):
        return [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                "--device", "cpu", "--steps", str(steps), "--batch", "2",
                "--seq", "8", "--ckpt-every", "2", "--ckpt-dir",
                str(tmp_path)]

    r = subprocess.run(cmd(4), capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0 and "[train] done: 4 steps" in r.stdout, \
        r.stdout + r.stderr
    r = subprocess.run(cmd(6), capture_output=True, text=True, timeout=300,
                       env=env)
    assert "[train] restored step 4" in r.stdout, r.stdout + r.stderr
    assert "[train] done: 6 steps" in r.stdout


def test_driver_cli_names_its_checkpoint_directory(capsys):
    """A run restores the newest checkpoint of its directory, so the CLI
    has no shared default: without ``--ckpt-dir`` it stops before any
    work."""
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--smoke", "--device", "cpu", "--steps", "1"])
    assert e.value.code == 2
    assert "--ckpt-dir" in capsys.readouterr().err
