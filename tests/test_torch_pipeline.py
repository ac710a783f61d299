"""The port's gpipe (parallel/pipeline.py) against the JAX package's.

The reference's pipeline test shapes (tests/test_system.py PIPE_SCRIPT: 8
layers of ``tanh(x @ w)``, D 16, 8 microbatches of 4 rows) on 4 stages,
and cases with 4, 3, 2 and 1 microbatches (below S the reference
re-injects the last one into the bubble): the port's forward on 4 gloo
ranks (spawned once, every case inside) against JAX's ``gpipe`` under a
4-device ``Auto``
mesh (a subprocess) within 1e-5, and the gradients of the outputs' sum
with respect to every stage's layers and to the inputs against
``jax.grad`` of the same, within 1e-5. The reference's own test of this
function fails on the installed JAX only for its mesh's ``Explicit`` axes
(``ROADMAP.md`` §3).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.parallel import launch, pipeline
from repro_torch.parallel.mesh_jobs import (PipelineJob, each, pipeline_job,
                                            sequential)

SRC = Path(__file__).resolve().parents[1] / "src"
L, D, MB, S = 8, 16, 4, 4
MICRO = (8, 4, 3, 2, 1)
# chip_smoke.py phase 10a's job on the CPU: qwen2-0.5b's no-cache training
# layer (its smoke width, bf16), 8 layers in 4 stages, 3 microbatches
QWEN2 = PipelineJob(stages=S, n_layers=8, arch="qwen2-0.5b", smoke=True,
                    micro=3, rows=1, seq=8)

SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.parallel.pipeline import gpipe
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((4,), ("stage",), axis_types=(auto,))
cases = pickle.load(open(sys.argv[1], "rb"))
out = []
for ws, xs in cases:
    apply = gpipe(lambda w, x: jnp.tanh(x @ w), mesh, "stage", ws.shape[0])
    ys = apply(jnp.asarray(ws), jnp.asarray(xs))
    gw, gx = jax.grad(lambda w, x: apply(w, x).sum(), argnums=(0, 1))(
        jnp.asarray(ws), jnp.asarray(xs))
    out.append((np.asarray(ys), np.asarray(gw), np.asarray(gx)))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _cases():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    return [(ws, rng.standard_normal((m, MB, D)).astype(np.float32))
            for m in MICRO]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    cases = _cases()
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, str(d / "in.pkl"),
                             str(d / "out.pkl")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        jobs = [PipelineJob(stages=S, n_layers=L, ws=ws, xs=xs)
                for ws, xs in cases] + [QWEN2]
        ours = launch.spawn(each, S, (pipeline_job, jobs),
                            store_dir=str(d / "store"), backend="gloo",
                            timeout_s=180.0)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out + err[-3000:]
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return jobs, [list(r) for r in zip(*ours)], ref


@pytest.mark.parametrize("case", range(len(MICRO)))
def test_gpipe_forward_and_grads_equal_jax(case, results):
    jobs, ours, ref = results
    ys, gw, gx = ref[case]
    per = L // S
    assert sorted(r["stage"] for r in ours[case]) == list(range(S))
    for r in ours[case]:
        s = r["stage"]
        np.testing.assert_allclose(r["ys"], ys, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["x_grad"], gx, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["w_grads"]["w"],
                                   gw[s * per:(s + 1) * per],
                                   rtol=1e-5, atol=1e-5)
        assert r["ticks"] == jobs[case].xs.shape[0] + S - 1
        assert r["launches"] == 0


def test_gpipe_equals_the_sequential_layers_bit_for_bit(results):
    """The ring moves bytes: each stage's layers see the inputs the
    sequential stack gives them, so the outputs and every gradient are
    the sequential ones exactly, for ``tanh(x @ w)`` and for qwen2-0.5b's
    training layer in bf16 (what chip_smoke.py phase 10a expects at full
    width)."""
    jobs, ours, _ = results
    for job, got in zip(jobs, ours):
        ref = sequential(job, torch.device("cpu"))
        per = job.n_layers // S
        for r in got:
            s = r["stage"]
            np.testing.assert_array_equal(r["ys"], ref["ys"])
            np.testing.assert_array_equal(r["x_grad"], ref["x_grad"])
            assert sorted(r["w_grads"]) == sorted(ref["w_grads"])
            for k, v in ref["w_grads"].items():
                np.testing.assert_array_equal(r["w_grads"][k],
                                              v[s * per:(s + 1) * per])
            micro = job.micro if job.xs is None else job.xs.shape[0]
            assert r["ticks"] == micro + S - 1 and r["launches"] == 0


def test_bubble_fraction():
    assert pipeline.bubble_fraction(4, 8) == 3 / 11
    assert pipeline.bubble_fraction(1, 8) == 0.0
    assert pipeline.bubble_fraction(4, 2) == 3 / 5


def test_gpipe_refuses_layers_that_do_not_split():
    from repro_torch.parallel.sharding import Mesh
    with pytest.raises(ValueError, match="do not split"):
        pipeline.gpipe(lambda w, x: x, Mesh.abstract((4,), ("stage",)),
                       "stage", 6)
