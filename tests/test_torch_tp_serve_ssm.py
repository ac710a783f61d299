"""The serving steps of the recurrent mixers on a rank's shards
(models/ssm.py ``mamba2_forward`` / ``mlstm_forward`` / ``slstm_forward``
with their leaves' and states' specs, through models/transformer.py
``hidden``) against the JAX package's partitioned steps.

The f32 smoke configs of xlstm-1.3b (seven mLSTM layers and an sLSTM
layer) and zamba2-1.2b (Mamba2 layers around the weight-shared attention
block), every norm scale perturbed so that a slice of each shows, under
the rules of their production decode cell (``launch/specs.rule_overrides``
of ``cell_config(arch, decode_32k)``), on the meshes (data 2, model 2),
(1, 4) and (1, 8); 4 slots × 32 rows:

  * a prefill of 6 tokens, then decode steps at positions 6 and 7;
  * a decode step at position 12 over states and caches drawn N(0, 1).

Splits covered: the fused projections cut across their parts (Mamba2's
``in_proj`` z | x | B | C | dt and conv channels x | B | C, the mLSTM's
``up_proj`` xi | z, the sLSTM's ``ff_up`` u | g at model 2); the
mLSTM's row-cut ``wq`` / ``wk`` / ``wv`` / ``w_if`` and its state whole
at model 8 (4 heads) beside its cut conv history; the sLSTM's carry by
heads at model 2 and 4 and whole at 8, its ``w_gates`` cut off its heads'
boundaries at 8; the norms over the inner row with their scales cut; the
FSDP gather over data at (2, 2).

The JAX side runs ``make_prefill_step`` / ``make_decode_step`` jitted on
an 8-device CPU mesh with ``Auto`` axes in a subprocess, from the same
weights and caches, and the same steps on one device, whose difference
from the partitioned steps is the reference's own spread. The port's
ranks run the same steps (parallel/mesh_jobs.py ``serve_job``), one
spawn of gloo ranks a mesh. Each rank's logits (its rows, the whole
vocabulary) and state / cache parts must be within 1e-5 of the largest
reference value; for xlstm, whose partitioned reference differs from its
one-device steps by ~1e-5 in f32, within twice that measured spread where
it is larger. The collectives of each rank's decode step equal the dry
run's trace of the same cell.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.parallel import launch, sharding
from repro_torch.parallel.mesh_jobs import ServeJob, each, serve_job
from repro_torch.train import step as step_lib
from test_torch_tp_serve_attn import _cell_rules, _is_spec, _perturbed

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("xlstm-1.3b", "zamba2-1.2b")
MESHES = ((2, 2), (1, 4), (1, 8))
B, S, L = 4, 32, 6
FILL_POS = 12
TOL = 1e-5
SPREAD_ARCHS = ("xlstm-1.3b",)   # bound: max(TOL, 2 × the ref.'s spread)

SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.models import transformer
from repro.parallel import sharding as shlib
from repro.train import step as steps
cases = pickle.load(open(sys.argv[1], "rb"))
auto = jax.sharding.AxisType.Auto
shapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(x.shape), t)
out, one = {}, {}

def both(cfg, params, c, sh):
    # sh: (mesh, param shardings) for the partitioned steps, None: one
    # device; each step jitted once for both runs
    pre, dec = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    zero = transformer.init_caches(cfg, c["B"], c["S"])
    if sh is None:
        put = lambda t: t
        pre, dec = jax.jit(pre), jax.jit(dec)
    else:
        mesh, p_sh = sh
        c_sh = shlib.tree_shardings(transformer.cache_logical_axes(cfg),
                                    shapes(zero), mesh)
        put = lambda t: jax.device_put(t, c_sh)
        pre = jax.jit(pre, in_shardings=(
            p_sh, shlib.named_sharding(("batch", None), c["prompt"].shape,
                                       mesh), c_sh, None))
        dec = jax.jit(dec, in_shardings=(
            p_sh, shlib.named_sharding(("batch", None), (c["B"], 1), mesh),
            c_sh, NamedSharding(mesh, P())))

    def run(caches, prompt, decode):
        logits = []
        if prompt is not None:
            lg, caches = pre(params, jnp.asarray(prompt), caches, None)
            logits.append(np.asarray(lg))
            caches = put(caches)
        for tok, pos in decode:
            lg, caches = dec(params, jnp.asarray(tok), caches,
                             jnp.asarray(pos, jnp.int32))
            logits.append(np.asarray(lg))
            caches = put(caches)
        return logits, [np.asarray(a) for a in
                        jax.tree_util.tree_leaves(caches)]

    filled = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(zero),
        [jnp.asarray(a) for a in c["fill"]])
    return {"steps": run(zero, c["prompt"], c["decode"]),
            "fill": run(put(filled), None, c["fill_decode"])}

for key, c in cases.items():
    arch, shape = key
    cfg = configs.get_smoke_config(arch, compute_dtype=jnp.float32,
                                   shard_kv_seq=c["kv_seq"])
    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    if arch not in one:
        one[arch] = both(cfg, params, c, None)
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(auto, auto),
                         devices=jax.devices()[:n])
    with shlib.use_mesh(mesh, c["rules"]):
        p_sh = shlib.tree_shardings(c["axes"], shapes(params), mesh)
        out[key] = both(cfg, params, c, (mesh, p_sh))
pickle.dump({"mesh": out, "one": one}, open(sys.argv[2], "wb"))
"""


def _rel(got, want) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on the JAX side (one subprocess) while the port's ranks
    run them (one spawn a mesh)."""
    d = tmp_path_factory.mktemp("tp_serve_ssm")
    rng = np.random.default_rng(2)
    cases, jobs = {}, {m: [] for m in MESHES}
    for i, arch in enumerate(ARCHS):
        kv_seq, rules = _cell_rules(arch)
        jcfg = jconfigs.get_smoke_config(arch, compute_dtype=jax.numpy.float32,
                                         shard_kv_seq=kv_seq)
        cfg = configs.get_smoke_config(arch, compute_dtype=torch.float32,
                                       shard_kv_seq=kv_seq)
        params, axes = _perturbed(jcfg, 20 + i)
        prompt = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
        decode = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32), p)
                  for p in (L, L + 1)]
        fill_decode = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
                        FILL_POS)]
        fill = [rng.standard_normal(a.shape).astype(np.float32) for a in
                jax.tree_util.tree_leaves(jtransformer.init_caches(jcfg, B,
                                                                   S))]
        for mesh in MESHES:
            cases[(arch, mesh)] = dict(
                params=params, axes=axes, rules=rules, kv_seq=kv_seq, B=B,
                S=S, prompt=prompt, decode=decode, fill=fill,
                fill_decode=fill_decode)
            jobs[mesh].append(ServeJob(cfg=cfg, mesh=mesh, rules=rules,
                                       batch=B, max_seq=S, prompt=prompt,
                                       decode=decode, weights=params))
            jobs[mesh].append(ServeJob(cfg=cfg, mesh=mesh, rules=rules,
                                       batch=B, max_seq=S,
                                       decode=fill_decode, weights=params,
                                       caches=fill))
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, str(d / "in.pkl"),
                             str(d / "out.pkl")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ours = {}
        for mesh in MESHES:
            n = mesh[0] * mesh[1]
            got = launch.spawn(each, n, (serve_job, jobs[mesh]),
                               store_dir=str(d / f"store{n}{mesh[0]}"),
                               backend="gloo", timeout_s=300.0)
            for j, arch in enumerate(ARCHS):
                ours[(arch, mesh)] = ([r[2 * j] for r in got],
                                      [r[2 * j + 1] for r in got])
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out + err[-3000:]
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, ours, cases


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", ("steps", "fill"))
def test_rank_steps_equal_the_partitioned_reference(arch, mesh, run,
                                                    results):
    ref, ours, cases = results
    j_logits, j_caches = ref["mesh"][(arch, mesh)][run]
    o_logits, o_caches = ref["one"][arch][run]
    spread = max(_rel(a, b) for a, b in zip(j_logits + j_caches,
                                            o_logits + o_caches))
    tol = max(TOL, 2 * spread) if arch in SPREAD_ARCHS else TOL
    ranks = ours[(arch, mesh)][0 if run == "steps" else 1]
    c = cases[(arch, mesh)]
    cfg = configs.get_smoke_config(arch, compute_dtype=torch.float32,
                                   shard_kv_seq=c["kv_seq"])
    amesh = sharding.Mesh.abstract(mesh, ("data", "model"))
    with sharding.use_mesh(amesh, c["rules"]):
        specs_leaves = jax.tree_util.tree_leaves(
            step_lib.rank_caches(cfg, B, S, amesh, device="meta")[1],
            is_leaf=_is_spec)
    worst = 0.0
    for r in ranks:
        lo, hi = r["rows"]
        assert len(r["logits"]) == len(j_logits)
        for k, (got, want) in enumerate(zip(r["logits"], j_logits)):
            err = _rel(got, want[lo:hi])
            worst = max(worst, err)
            assert err <= tol, (f"{arch} {mesh} {run} rank {r['coords']} "
                                f"logits of step {k}: {err:.3e} > {tol:.3e}")
        for i, (got, want, spec) in enumerate(zip(r["caches"], j_caches,
                                                  specs_leaves)):
            part = sharding.shard_slices(want.shape, spec, amesh,
                                         amesh.rank_at(r["coords"]))
            err = _rel(got, want[part])
            worst = max(worst, err)
            assert err <= tol, (f"{arch} {mesh} {run} rank {r['coords']} "
                                f"cache leaf {i}: {err:.3e} > {tol:.3e}")
        assert not any(m == "recurrent" for m, _ in r["launches_by_mixer"]
                       ), r["launches_by_mixer"]
    print(f"{arch} {mesh} {run}: port vs partitioned reference {worst:.3e}, "
          f"reference partitioned vs one device {spread:.3e}, bound "
          f"{tol:.3e}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_collectives_equal_the_dry_run_trace(arch, mesh, results):
    """The collectives each rank issued in its decode step over the filled
    caches (kind, bytes, group size, in order) are those
    ``launch/specs.trace_cell`` records for the same cell (B 4, S 32, f32)
    traced on ``meta`` over the abstract mesh of that shape."""
    _, ours, cases = results
    kv_seq = cases[(arch, mesh)]["kv_seq"]
    cell = specs.build_cell(
        arch, configs.ShapeSpec("decode_32k", S, B, "decode"),
        sharding.Mesh.abstract(mesh, ("data", "model")), smoke=True,
        cfg_over=dict(compute_dtype=torch.float32,
                      param_dtype=torch.float32, shard_kv_seq=kv_seq))
    assert not cell.gaps, cell.gaps
    want = [(c.kind, c.nbytes, c.group)
            for c in specs.trace_cell(cell).collectives]
    assert want
    for r in ours[(arch, mesh)][1]:
        assert [tuple(c) for c in r["collectives"]] == want, r["coords"]


@pytest.mark.parametrize("shape", ("decode_32k", "prefill_32k", "long_500k"))
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_serving_cells_have_no_gaps_on_16x16(arch, shape):
    """At full width on the abstract 16x16 mesh every leaf of the six
    recurrent serving cells has a rank path: ``build_cell`` names no gap
    (it builds the rank's arguments on ``meta`` alone, no trace)."""
    cell = specs.build_cell(arch, configs.SHAPES[shape],
                            sharding.Mesh.abstract((16, 16),
                                                   ("data", "model")))
    assert not cell.gaps, cell.gaps
