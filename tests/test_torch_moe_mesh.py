"""The MoE's mesh paths (models/moe.py) against the JAX package's.

The reference's MoE dispatch script (tests/test_moe_dispatch.py: d 32, 8
experts, top-2, d_ff 16, 1 shared expert, capacity factor 2.0; B 4, L 8)
on a (data 2, model 4) mesh: 8 gloo ranks, spawned once for every case,
against JAX's ``moe_forward`` under an 8-device ``Auto`` mesh (a
subprocess). Cases: the gather / EP path (``ep``, 8 experts over 4; and
at top-1), the a2a dispatch, the slot-parallel path (``ep=False``,
granite's) and 6 experts, which do not divide the model axis
(slot-parallel with ``C_pad`` past C); a2a asked for with ``ep=False`` or
with 6 experts takes the slot-parallel path, as the reference's. For
each:

  * y within 2e-4 of JAX's (each rank's rows) and aux within 1e-6;
  * the gradients of Σ y·r (r fixed) with respect to x, the router, the
    shared experts and the experts (each rank's EP shard) against
    ``jax.grad`` under the mesh within 2e-4;
  * the gradients of aux. The reference's mesh path cannot take them on
    the installed JAX (its ``_pmean_grad_safe`` returns an invariant
    cotangent for a varying input: tests/test_torch_fsdp.py pins it), so
    they are held against ``jax.grad`` of the mean over the mesh's shards
    (data shards; data × sequence shards for a2a) of the meshless aux,
    the quantity the mesh path computes: the router's, its mean over the
    data ranks, and x's, each data rank's share times the data ranks
    (the mean over the batch ranks of their gradients is the step's:
    parallel/sharding.py).

With routing per shard (a2a's sequence shards) the outputs differ from
the meshless dispatch's; the reference's own criterion, at least 95 % of
elements within 1e-3 of the meshless output, holds as well.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.models import moe as jmoe
from repro.models.blocks import split_params as jsplit
from repro_torch.models import moe as tmoe
from repro_torch.parallel import launch
from repro_torch.parallel.mesh_jobs import MoeJob, each, ep_experts, moe_job

SRC = Path(__file__).resolve().parents[1] / "src"
MESH = (2, 4)
B, L, D = 4, 8, 32
BASE = dict(d_model=D, n_experts=8, top_k=2, d_ff=16, n_shared=1,
            capacity_factor=2.0)
CASES = {"gather": {}, "a2a": dict(dispatch="a2a"), "slot": dict(ep=False),
         "e6": dict(n_experts=6), "top1": dict(top_k=1),
         "a2a_slot": dict(dispatch="a2a", ep=False),
         "a2a_e6": dict(dispatch="a2a", n_experts=6)}
PATHS = {"gather": "ep", "a2a": "a2a", "slot": "slot", "e6": "slot",
         "top1": "ep", "a2a_slot": "slot", "a2a_e6": "slot"}

SCRIPT = r"""
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe
from repro.models.blocks import split_params
from repro.parallel import sharding as shlib
base, cases, x, r = pickle.load(open(sys.argv[1], "rb"))
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(auto, auto))
out = {}
tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
for name, kw in cases.items():
    c = moe.MoeConfig(**dict(base, **kw))
    p, _ = split_params(moe.init_moe(jax.random.PRNGKey(0), c))
    y0, _ = moe.moe_forward(p, jnp.asarray(x), c)
    with shlib.use_mesh(mesh):
        y, aux = jax.jit(lambda p_, x_: moe.moe_forward(p_, x_, c))(p, x)
        gp, gx = jax.jit(jax.grad(
            lambda p_, x_: (moe.moe_forward(p_, x_, c)[0] * r).sum(),
            argnums=(0, 1)))(p, x)
    B, L = x.shape[:2]
    if c.dispatch == "a2a" and c.ep and c.n_experts % 4 == 0:
        shards = [(slice(i * B // 2, (i + 1) * B // 2),
                   slice(m * L // 4, (m + 1) * L // 4))
                  for i in range(2) for m in range(4)]
    else:
        shards = [(slice(i * B // 2, (i + 1) * B // 2), slice(None))
                  for i in range(2)]
    mean_aux = lambda p_, x_: sum(moe.moe_forward(p_, x_[a, b], c)[1]
                                  for a, b in shards) / len(shards)
    ga_p, ga_x = jax.grad(mean_aux, argnums=(0, 1))(p, jnp.asarray(x))
    out[name] = dict(p=tonp(p), y=np.asarray(y), y0=np.asarray(y0),
                     aux=float(aux), gp=tonp(gp), gx=np.asarray(gx),
                     aux_oracle=float(mean_aux(p, jnp.asarray(x))),
                     ga_p=tonp(ga_p), ga_x=np.asarray(ga_x))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """JAX's mesh paths in a subprocess while the port's cases run on the
    8 ranks, both from the reference's ``init_moe(PRNGKey(0))`` weights."""
    d = tmp_path_factory.mktemp("moe_mesh")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    r = rng.standard_normal((B, L, D)).astype(np.float32)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((BASE, CASES, x, r), f)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, str(d / "in.pkl"),
                             str(d / "out.pkl")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        jobs = []
        for name in CASES:
            kw = dict(BASE, **CASES[name])
            p = jsplit(jmoe.init_moe(jax.random.PRNGKey(0),
                                     jmoe.MoeConfig(**kw)))[0]
            jobs.append(MoeJob(cfg=tmoe.MoeConfig(**kw), mesh=MESH,
                               weights=jax.tree_util.tree_map(np.asarray, p),
                               x=x, r=r))
        ours = launch.spawn(each, MESH[0] * MESH[1], (moe_job, jobs),
                            store_dir=str(d / "store"), backend="gloo",
                            timeout_s=240.0)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out + err[-3000:]
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, [list(o) for o in zip(*ours)]


def _whole(got, key, grads=None):
    """Each data rank's rows of ``key`` (or of a gradient) put together."""
    out = np.zeros((B, L, D), np.float32)
    for o in got:
        rows = slice(o["coords"]["data"] * B // MESH[0],
                     (o["coords"]["data"] + 1) * B // MESH[0])
        out[rows] = o[key] if grads is None else o[grads][key]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_path_equals_jax(name, results):
    ref, ours = results
    got = ours[list(CASES).index(name)]
    R = ref[name]
    cfg = tmoe.MoeConfig(**dict(BASE, **CASES[name]))
    ep, held = ep_experts(cfg, MESH[1])
    assert {o["path"] for o in got} == {PATHS[name]}
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_whole(got, "y"), R["y"], **tol)
    np.testing.assert_allclose(_whole(got, "x", "grads_y"), R["gx"], **tol)
    # aux's gradient: each data rank's x share is data-ranks × the mean's
    np.testing.assert_allclose(_whole(got, "x", "grads_aux"),
                               MESH[0] * R["ga_x"], rtol=2e-4, atol=1e-8)
    for o in got:
        assert abs(o["aux"] - R["aux"]) <= 1e-6 * abs(R["aux"])
        assert abs(o["aux"] - R["aux_oracle"]) <= 1e-6 * abs(R["aux"])
        m = o["coords"]["model"]
        for k in ("w_gate", "w_up", "w_down"):
            want = R["gp"][k][m * held:(m + 1) * held] if ep else R["gp"][k]
            np.testing.assert_allclose(o["grads_y"][k], want, **tol)
        np.testing.assert_allclose(o["grads_y"]["router"], R["gp"]["router"],
                                   **tol)
        for k in ("w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(o["grads_y"][f"shared.{k}"],
                                       R["gp"]["shared"][k], **tol)
        np.testing.assert_allclose(o["grads_aux"]["router"],
                                   R["ga_p"]["router"], rtol=2e-4,
                                   atol=1e-9)
        assert o["launches"] == 0


def test_the_reference_criterion_against_the_meshless_path(results):
    """The reference's test_moe_dispatch check: gather within 2e-4 of the
    meshless output, a2a (routed per sequence shard) within 1e-3 on at
    least 95 % of elements."""
    ref, ours = results
    for name in CASES:
        y = _whole(ours[list(CASES).index(name)], "y")
        close = np.abs(y - ref[name]["y0"]) < 1e-3
        if name == "a2a":
            assert close.mean() > 0.95, close.mean()
        else:
            np.testing.assert_allclose(y, ref[name]["y0"], rtol=2e-4,
                                       atol=2e-4)


def test_ep_shards_must_match_the_mesh():
    """Under EP a rank holds E/M experts; whole leaves are refused."""
    import torch
    from repro_torch.parallel import sharding
    cfg = tmoe.MoeConfig(**BASE)

    class OneLine:        # a one-rank model line: no process group needed
        shape = {"data": 1, "model": 4}

        def line(self, axes):
            return sharding.Line(("model",), 1, 0, (0,), None)

    p = {"router": torch.zeros(D, 8), "w_gate": torch.zeros(8, D, 16),
         "w_up": torch.zeros(8, D, 16), "w_down": torch.zeros(8, 16, D)}
    with sharding.use_mesh(OneLine()), pytest.raises(ValueError,
                                                     match="hold 2 a rank"):
        tmoe.moe_forward(p, torch.zeros(1, 4, D), cfg)
