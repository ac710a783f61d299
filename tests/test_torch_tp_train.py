"""Training with a model axis (train/step.py ``shard_state`` under the
cell's rules, models/transformer.py ``train_forward`` on a rank's shards,
train/loss.py's vocabulary-parallel loss) against the JAX package's
partitioned train step, and the sharding page table and software TLB
(core/vmm.py) against the reference's.

The f32 smoke configs of qwen2-0.5b, minitron-4b, gemma3-27b (its unit
cut to one local and one global layer: the reference's partitioned step
of the six-layer unit compiles three times as long) and
granite-moe-3b-a800m (every norm and bias perturbed:
tests/test_torch_train_common.py), under the rules of their ``train_4k``
cell (``launch/specs.rule_overrides``), on the meshes (data 2, model 2)
and (1, 8): two steps of a global batch of 4 in 2 microbatches, AdamW at
the reference's default config, on gloo ranks spawned once a mesh
(parallel/mesh_jobs.py ``fsdp_job``). Splits covered: at (1, 8) qwen2's
q columns are half a head and its k / v columns a quarter of a kv head
(the projections gathered and used apart: ``take(..., apart=True)``), the
vocabulary is cut 8 ways (the loss over the line); at (2, 2) the FSDP
gather over data beside the model axis; gemma3's window and sandwich
norms; granite's whole experts on the slot-parallel path.

The oracles: for qwen2, minitron and gemma3 the reference's
``make_train_step`` jitted on an 8-device CPU mesh with ``Auto`` axes
(one subprocess a mesh, started first); for granite, whose mesh step the
installed JAX refuses (``ROADMAP.md`` §3), the reference's semantics from
its meshless functions: per step the mean over (microbatch, data shard)
of ``value_and_grad(make_loss_fn)`` on each shard's rows (the MoE routes
each data shard alone), then ``adamw.update``
(tests/test_torch_train_common.py ``shard_oracle``). Held at tests/test_torch_train_step.py's tolerances: every
metric on every rank within 1e-5; each rank's weight, m and v shards
within 1e-5 of its slices of the reference's; each element's change over
a step within 1e-4 of lr and the moments within 1e-5 of each leaf's
largest, but for the elements whose step the rounding decides
(``unsettled``, counted and bounded); and each rank's gradient shards of
the first step within 1e-5 (of each leaf's largest) of its slices of the
reference's gradient: granite's construction's, and for the other archs
the partitioned step's own, read back from its first moment (as the
rank's own are read back from its). On (2, 2), qwen2's state after the
two steps is saved whole from the ranks' shards and restored by the same
ranks: each rank's restored shards equal its saved ones.

The page table and the TLB: on (2, 2) and (1, 4) shardings of a 2-D
shape (cut both ways, one way and replicated), the port's walks, and a
TLB trace of translations, prefetches and evictions with its hits,
misses and hit rate after each operation, equal the reference's (the same
subprocess); and the reference's own two TLB tests, on the port. The
other layer kinds' smoke steps (cross, encoder, MLA, recurrent) trace on
an abstract (1, 4) mesh (tests/test_torch_tp_train_layers.py holds their
values).
"""
import functools
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

import test_torch_train_step as tts
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.core import tree as tree_lib
from repro_torch.core import vmm
from repro_torch.launch import specs
from repro_torch.models import transformer
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import launch, sharding
from repro_torch.parallel.mesh_jobs import FsdpJob, each, fsdp_job
from repro_torch.train import step as tstep
from test_torch_train_common import batch, shard_oracle, weights

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("qwen2-0.5b", "minitron-4b", "gemma3-27b", "granite-moe-3b-a800m")
MESH_STEP = ARCHS[:3]       # held against the reference's mesh step
MESHES = ((2, 2), (1, 8))
GA = 2
STEPS = 2
GLOBAL_BATCH = 4
TOL = tts.TOL
# granite's tied embedding: rows no token of a shard's batch reads (as in
# tests/test_torch_fsdp.py)
MAX_UNSETTLED = {"granite-moe-3b-a800m": 0.05}
# gemma3-27b's smoke unit (5 local + 1 global layers) cut to one of each:
# the reference's partitioned step compiles in a third of the time
DEPTH = {"gemma3-27b": ((("local:mlp", "global:mlp"), 1),)}
# the page table: (mesh, spec) shardings of a (64, 32) leaf; the TLB
# trace's pages and capacity
TABLE_SHAPE = (64, 32)
SHARDINGS = {(2, 2): (("data", "model"), ("data", None), (None, None)),
             (1, 4): ((None, "model"), ("model", None))}
PAGE, CAPACITY = (8, 8), 4
# the checkpoint round trip: the arch and mesh whose state is saved
SAVED = ("qwen2-0.5b", (2, 2))

MESH_SCRIPT = r"""
import os, pickle, sys, concurrent.futures as cf
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import vmm
from repro.models import blocks, transformer
from repro.optim import adamw
from repro.parallel import sharding as shlib
from repro.train import step as jstep

c = pickle.load(open(sys.argv[1], "rb"))
auto = jax.sharding.AxisType.Auto
shape = c["mesh"]
mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(auto, auto),
                     devices=jax.devices()[:shape[0] * shape[1]])
tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
jobs = []
for arch, (cfg, tree, batches) in c["archs"].items():
    axes = blocks.split_params(jax.eval_shape(
        lambda: transformer.init_model(jax.random.PRNGKey(0), cfg)))[1]
    with shlib.use_mesh(mesh, c["rules"][arch]):
        sh = shlib.tree_shardings(axes, jax.tree_util.tree_map(
            lambda x: tuple(x.shape), tree), mesh)
        params = jax.tree_util.tree_map(jax.device_put, tree, sh)
        state = jstep.TrainState(params=params, opt=adamw.init(params),
                                 step=jnp.zeros((), jnp.int32))
        low = jax.jit(jstep.make_train_step(
            cfg, adamw.Config(), grad_accum=c["ga"])).lower(
                state, jb(batches[0]))
    jobs.append((arch, state, low, batches))
with cf.ThreadPoolExecutor(len(jobs)) as ex:   # XLA compiles apart
    compiled = list(ex.map(lambda j: j[2].compile(), jobs))
out = {}
for (arch, state, _, batches), step in zip(jobs, compiled):
    steps = []
    # the next step takes the state at the shardings it was compiled for
    # (XLA may lay a leaf of the new state out otherwise: the sLSTM's)
    held = step.input_shardings[0][0]
    with shlib.use_mesh(mesh, c["rules"][arch]):
        for b in batches:
            state, m = step(state, jb(b))
            state = jax.device_put(state, held)
            steps.append(({k: float(v) for k, v in m.items()}, tonp(state)))
    out[arch] = steps
tlb = {}
for tshape, specs in c.get("tables", {}).items():
    tmesh = jax.make_mesh(tshape, ("data", "model"), axis_types=(auto, auto),
                          devices=jax.devices()[:tshape[0] * tshape[1]])
    for spec in specs:
        table = vmm.ShardingPageTable(c["table_shape"],
                                      NamedSharding(tmesh, P(*spec)))
        walks = [table.walk(x) for x in c["coords"]]
        t = vmm.Tlb(table, c["page"], c["capacity"])
        trace = []
        for op, x in c["ops"]:
            tr = t.translate(x) if op == "translate" else t.prefetch(x)
            trace.append((tr, t.hits, t.misses, t.hit_rate))
        tlb[(tshape, spec)] = ([(w.device_index, w.local_offset,
                                 w.shard_shape) for w in walks],
                               [(None if tr is None else (
                                   tr.device_index, tr.local_offset,
                                   tr.shard_shape), h, m, r)
                                for tr, h, m, r in trace])
out["tlb"] = tlb
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _rules(arch):
    return specs.rule_overrides(specs.cell_config(
        arch, configs.SHAPES["train_4k"], smoke=True))


def _tlb_program(seed=0):
    """Coordinates to walk and a TLB trace (translations with some
    repeats, so that pages hit, miss and are evicted, and prefetches)."""
    rng = np.random.default_rng(seed)
    coords = [tuple(int(v) for v in rng.integers(0, n, 40))
              for n in TABLE_SHAPE]
    coords = list(zip(*coords))
    ops = []
    for i in range(60):
        x = coords[int(rng.integers(0, 12))] if i % 3 else \
            tuple(int(rng.integers(0, n)) for n in TABLE_SHAPE)
        ops.append(("prefetch" if i % 7 == 3 else "translate", x))
    return coords, ops


def _port_tlb(tshape, spec):
    coords, ops = _tlb_program()
    mesh = sharding.Mesh.abstract(tshape, ("data", "model"))
    table = vmm.ShardingPageTable(TABLE_SHAPE,
                                  sharding.NamedSharding(mesh, spec))
    walks = [table.walk(x) for x in coords]
    t = vmm.Tlb(table, PAGE, CAPACITY)
    trace = []
    for op, x in ops:
        tr = t.translate(x) if op == "translate" else t.prefetch(x)
        trace.append((None if tr is None else (
            tr.device_index, tr.local_offset, tr.shard_shape), t.hits,
            t.misses, t.hit_rate))
    return ([(w.device_index, w.local_offset, w.shard_shape)
             for w in walks], trace)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's mesh steps and TLB traces (one subprocess a mesh,
    started first), the port's ranks (one spawn a mesh, each in a thread:
    (1, 8) at once, (2, 2) once the subprocesses end, so that fewer
    processes contend for the cores) and granite's oracles (in this
    process, meanwhile)."""
    d = tmp_path_factory.mktemp("tp_train")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    coords, ops = _tlb_program()
    procs = {}
    archs = {a: (weights(a, DEPTH.get(a))[0], weights(a, DEPTH.get(a))[1],
                 [batch(a, s, GLOBAL_BATCH) for s in range(STEPS)])
             for a in MESH_STEP}
    for mesh in MESHES:
        case = dict(mesh=mesh, archs=archs, ga=GA,
                    rules={a: _rules(a) for a in MESH_STEP})
        if mesh == MESHES[0]:
            case.update(tables=SHARDINGS, table_shape=TABLE_SHAPE,
                        coords=coords, ops=ops, page=PAGE,
                        capacity=CAPACITY)
        inp, outp = d / f"in{mesh}.pkl", d / f"out{mesh}.pkl"
        with open(inp, "wb") as f:
            pickle.dump(case, f)
        with open(d / f"log{mesh}.txt", "w") as log:
            procs[mesh] = (subprocess.Popen(
                [sys.executable, "-c", MESH_SCRIPT, str(inp), str(outp)],
                env=env, stdout=log, stderr=subprocess.STDOUT), outp)
    ours, errors = {}, []

    def run_ranks(meshes, after=()):
        try:
            for proc, _ in after:         # the reference's passes first
                proc.wait()
            for mesh in meshes:
                jobs = []
                for arch in ARCHS:
                    _, tree, tcfg = weights(arch, DEPTH.get(arch))
                    jobs.append(FsdpJob(
                        cfg=tcfg, weights=tree, grad_accum=GA,
                        batches=[batch(arch, s, GLOBAL_BATCH)
                                 for s in range(STEPS)],
                        mesh=mesh, rules=_rules(arch), wholes=False,
                        shards=True, save_dir=str(d / "saved")
                        if (arch, mesh) == SAVED else None))
                if mesh == SAVED[1]:      # restored by the same ranks
                    _, tree, tcfg = weights(SAVED[0])
                    jobs.append(FsdpJob(
                        cfg=tcfg, weights=tree, batches=[], mesh=mesh,
                        rules=_rules(SAVED[0]), wholes=False, shards=True,
                        restore_dir=str(d / "saved")))
                n = mesh[0] * mesh[1]
                got = launch.spawn(each, n, (fsdp_job, jobs),
                                   store_dir=str(d / f"store{mesh}"),
                                   backend="gloo", timeout_s=300.0)
                for j, arch in enumerate(ARCHS):
                    ours[(arch, mesh)] = [r[j] for r in got]
                if mesh == SAVED[1]:
                    ours["restored"] = [r[-1] for r in got]
        except BaseException as e:        # re-raised in the fixture
            errors.append(e)

    try:
        for arch in ARCHS:                # the batches, before the thread
            weights(arch, DEPTH.get(arch))
            for s in range(STEPS):
                batch(arch, s, GLOBAL_BATCH)
        threads = [threading.Thread(target=run_ranks, args=(MESHES[1:],)),
                   threading.Thread(target=run_ranks,
                                    args=(MESHES[:1], procs.values()))]
        for t in threads:
            t.start()
        oracles = {(arch, m[0]): shard_oracle(arch, m[0], GA,
                                              groups=DEPTH.get(arch),
                                              steps=STEPS,
                                              global_batch=GLOBAL_BATCH)
                   for arch in ARCHS if arch not in MESH_STEP
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


@functools.lru_cache(maxsize=None)
def state_specs(arch, mesh, depth=None):
    """Each leaf of ``state_tree``'s spec on the abstract mesh, under the
    cell's rules (``depth``: the arch's layer groups cut, as
    ``weights``')."""
    amesh = sharding.Mesh.abstract(mesh, ("data", "model"))
    cfg = weights(arch, depth)[2]
    with sharding.use_mesh(amesh, _rules(arch)):
        p_specs = tstep.param_specs(transformer.init_model(
            cfg, device="meta"), amesh)
    return amesh, tree_lib.leaves(tstep.state_specs(p_specs),
                                  is_leaf=sharding.is_spec)


def _reference(arch, mesh, results):
    """[(metrics, numpy state leaves)] a step: the reference's mesh step,
    or the oracle for granite."""
    ref, _, oracles = results
    if arch in MESH_STEP:
        return [(m, jax.tree_util.tree_leaves(st))
                for m, st in ref[mesh][arch]]
    return [(m, jax.tree_util.tree_leaves(st))
            for m, st, _ in oracles[(arch, mesh[0])]]


def _read_back(steps, cfg):
    """Each step's gradient leaves (numpy, before the clip) from the
    first moment, m_s = b1·m_(s-1) + (1 - b1)·g_s·scale_s, scale_s =
    min(1, clip_norm / grad_norm_s) (``adamw.update``, the same in both
    packages), within a few f32 roundings of m. ``steps``: [(metrics, the
    m leaves)] a step; ``cfg``: the AdamW config."""
    out, m_old = [], None
    for metrics, m in steps:
        scale = 1.0 if cfg.clip_norm is None else min(
            1.0, cfg.clip_norm / max(metrics["grad_norm"], 1e-9))
        m = [np.asarray(a, np.float32) for a in m]
        # b1·m_(s-1) rounded as the step rounds it: a zero gradient reads
        # back as zero
        out.append([(a if m_old is None else a - np.float32(cfg.b1) * b)
                    / np.float32((1 - cfg.b1) * scale)
                    for a, b in zip(m, m_old or m)])
        m_old = m
    return out


def _grads(arch, mesh, results):
    """The reference's gradient leaves of each step: the oracle's for
    granite; for the other archs read back from the partitioned step's
    first moment."""
    if arch not in MESH_STEP:
        return [g for _, _, g in results[2][(arch, mesh[0])]]
    return _read_back([(metrics, jax.tree_util.tree_leaves(state.opt.m))
                       for metrics, state in results[0][mesh][arch]],
                      jadamw.Config())


def _top(leaves):
    return max(float(np.abs(a).max()) for a in leaves)


def hold_steps(arch, mesh, ranks, ref, grads, depth=None,
               max_unsettled=tts.MAX_UNSETTLED, model_scale=False,
               null=(), ulps=0, propagate=False):
    """Every rank's metrics and weight / m / v shards of each step
    (``ranks``: the ranks' ``fsdp_job`` results) against the reference's
    (``ref``: [(metrics, numpy state leaves)] a step; ``grads``: its
    gradient leaves of each step), as the module docstring sets out.
    ``model_scale``: the m / v tolerance scaled by the whole model's
    largest m (v) rather than its own leaf's; ``null``:
    the leaves (by path suffix) whose gradient is zero in exact
    arithmetic, every element unsettled; ``ulps``: an update's allowance
    in ulps of the larger of the old and the new weight (0: two of the
    new weight's); ``propagate``: each element's update allowance also
    holds what a change of its gradient by the gradients' own tolerance
    (1e-5 of its leaf's largest) moves Adam's step by (:func:`_moved`)."""
    amesh, leaf_specs = state_specs(arch, mesh, depth)
    names = [p for p, _ in tree_lib.paths(weights(arch, depth)[1])]
    n_params = len(names)
    assert len(ranks) == mesh[0] * mesh[1]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    flagged = None
    for s, (jm, jleaves) in enumerate(ref):
        tm = ranks[0]["metrics"][s]
        assert sorted(tm) == sorted(jm)
        for k in jm:
            tts.close(np.float32(tm[k]), jm[k])
        now = [np.ones(g.shape, bool) if name.endswith(tuple(null)) else
               tts.unsettled(g, None) for name, g in zip(names, grads[s])]
        tops = [_top(jleaves[k * n_params:(k + 1) * n_params])
                for k in range(3)]
        flagged = now if flagged is None else [
            a | c for a, c in zip(flagged, now)]
        n_out = sum(int(f.sum()) for f in flagged)
        assert n_out <= max_unsettled * sum(f.size for f in flagged), n_out
        lr = jm["lr"]
        j_old = ref[s - 1][1] if s else [
            np.asarray(a) for a in jax.tree_util.tree_leaves(
                weights(arch, depth)[1])]
        for r in ranks:
            rank = amesh.rank_at(r["coords"])
            new, old = r["shards"][s + 1], r["shards"][s]
            assert len(new) == len(jleaves) == len(leaf_specs)
            assert int(new[-1]) == s + 1
            for i, (t, a, spec) in enumerate(zip(new, jleaves,
                                                 leaf_specs)):
                part = sharding.shard_slices(np.shape(a), spec, amesh,
                                             rank)
                tts.close(t, np.asarray(a)[part])
                if i >= 3 * n_params:       # the step
                    continue
                keep = ~flagged[i % n_params][part]
                if i < n_params:            # the update
                    err = np.abs((t - old[i]) - (np.asarray(a)[part]
                                                 - j_old[i][part]))
                    ulp = 2 * np.spacing(np.abs(np.asarray(a)[part]))
                    if ulps:
                        ulp = ulps * np.spacing(np.maximum(
                            np.abs(np.asarray(a)[part]),
                            np.abs(j_old[i][part])))
                    tol = tts.UPDATE_TOL * lr + ulp
                    if propagate:
                        tol = tol + lr * _moved(
                            grads[s][i][part], TOL * np.abs(
                                grads[s][i]).max(), jm["grad_norm"], s,
                            *(ref[s - 1][1][k * n_params + i][part]
                              if s else 0.0 for k in (1, 2)))
                    assert (err <= tol)[keep].all(), (
                        arch, mesh, s, i, float((err / lr)[keep].max()),
                        int((err > tol)[keep].sum()), t.size)
                else:                       # m and v
                    scale = tops[i // n_params] if model_scale else \
                        float(np.abs(a).max())
                    assert (np.abs(t - np.asarray(a)[part]) <= TOL * (
                        np.abs(np.asarray(a)[part]) + scale))[keep].all(), \
                        (arch, mesh, s, i)


def _moved(g, dg, gnorm, s, m_old, v_old, cfg=tadamw.Config()):
    """|d(Adam's step)/dg|·dg at step ``s`` (0-based) from the moments
    before it: m = b1·m_old + (1 - b1)·c·g, v = b2·v_old + (1 - b2)·(c·g)²
    with c the clip's scale at ``gnorm``, the step m̂ / (√v̂ + eps) with
    the bias corrections of ``adamw.update``."""
    c = 1.0 if cfg.clip_norm is None else min(1.0, cfg.clip_norm /
                                               max(gnorm, 1e-9))
    t = s + 1
    bc1, bc2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t
    g = np.asarray(g, np.float64)
    m = cfg.b1 * np.asarray(m_old, np.float64) + (1 - cfg.b1) * c * g
    v = cfg.b2 * np.asarray(v_old, np.float64) + (1 - cfg.b2) * (c * g) ** 2
    root = np.sqrt(v / bc2)
    dm = (1 - cfg.b1) * c / bc1
    droot = np.where(root > 0, (1 - cfg.b2) * c * c * g / (
        bc2 * np.maximum(root, 1e-300)), 0.0)
    du = dm / (root + cfg.eps) - (m / bc1) * droot / (root + cfg.eps) ** 2
    return np.abs(du) * dg


def hold_first_gradients(arch, mesh, ranks, want, depth=None,
                         model_scale=False):
    """Each rank's gradient shards of the first batch (the mean over the
    microbatches and the batch ranks, read back from its first moment)
    against its slices of the reference's gradient ``want`` (numpy
    leaves), within 1e-5 of each leaf's largest (``model_scale``: of the
    whole model's largest): every leaf reached, the model-cut ones summed
    over no line, the whole ones alike on a line."""
    amesh, leaf_specs = state_specs(arch, mesh, depth)
    names = [p for p, _ in tree_lib.paths(weights(arch, depth)[1])]
    n = len(names)
    cut = 0
    top = _top(want)
    for r in ranks:
        rank = amesh.rank_at(r["coords"])
        got = _read_back([(r["metrics"][0], r["shards"][1][n:2 * n])],
                         tadamw.Config())[0]
        assert len(got) == len(want) == n
        for name, g, a, spec in zip(names, got, want, leaf_specs):
            part = sharding.shard_slices(a.shape, spec, amesh, rank)
            scale = top if model_scale else float(np.abs(a).max())
            err = float(np.abs(g - a[part]).max())
            assert err <= TOL * scale, (arch, mesh, name, rank, err, scale)
            cut += "model" in sharding.spec_axes(spec)
    assert cut > 0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_steps_equal_the_partitioned_reference(arch, mesh, results):
    hold_steps(arch, mesh, results[1][(arch, mesh)],
               _reference(arch, mesh, results), _grads(arch, mesh, results),
               DEPTH.get(arch),
               MAX_UNSETTLED.get(arch, tts.MAX_UNSETTLED))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_first_gradient_shards_equal_the_reference(arch, mesh, results):
    """The first step's gradient shards (:func:`hold_first_gradients`)."""
    hold_first_gradients(arch, mesh, results[1][(arch, mesh)],
                         _grads(arch, mesh, results)[0], DEPTH.get(arch))


def test_checkpoint_round_trip_on_the_model_axis(results):
    """qwen2's state after its two steps on (2, 2), saved whole from the
    ranks' shards (train/step.py ``whole_state``) and restored by the same
    ranks (``state_shardings``): each rank's restored shards equal its
    saved ones, bit for bit, the step included."""
    saved, restored = results[1][SAVED], results[1]["restored"]
    assert len(saved) == len(restored) == SAVED[1][0] * SAVED[1][1]
    for a, b in zip(saved, restored):
        assert a["coords"] == b["coords"]
        want, got = a["shards"][-1], b["shards"][0]
        assert len(got) == len(want) and int(got[-1]) == STEPS
        for x, y in zip(got, want):
            assert x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("tshape", sorted(SHARDINGS),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_page_table_and_tlb_equal_the_reference(tshape, results):
    ref = results[0][MESHES[0]]["tlb"]
    for spec in SHARDINGS[tshape]:
        walks, trace = _port_tlb(tshape, spec)
        want_walks, want_trace = ref[(tshape, spec)]
        assert walks == want_walks, spec
        assert trace == want_trace, spec
        assert trace[-1][1] > 0 and trace[-1][2] > CAPACITY, trace[-1]


def test_tlb_eviction_and_prefetch():
    """tests/test_vmm_paging.py's TLB test, on the port."""
    mesh = sharding.Mesh.abstract((1,), ("data",))
    table = vmm.ShardingPageTable((1024,),
                                  sharding.NamedSharding(mesh, ("data",)))
    tlb = vmm.Tlb(table, page_shape=(64,), capacity=2)
    tlb.translate((0,))
    tlb.translate((128,))
    tlb.translate((512,))   # evicts page 0 (LRU, capacity 2)
    h0 = tlb.hits
    tlb.translate((1,))     # page 0 again → miss (was evicted)
    assert tlb.misses == 4
    tlb.prefetch((700,))
    tlb.translate((701,))   # prefetched → hit
    assert tlb.hits == h0 + 1


def test_page_table_walk_and_tlb():
    """tests/test_core_properties.py's walk and TLB test, on the port."""
    mesh = sharding.Mesh.abstract((1,), ("data",))
    table = vmm.ShardingPageTable((64, 8),
                                  sharding.NamedSharding(mesh, ("data",)))
    tr = table.walk((5, 3))
    assert tr.local_offset == (5, 3)
    tlb = vmm.Tlb(table, page_shape=(8, 8), capacity=4)
    for i in range(16):
        tlb.translate((i % 64, i % 8))
    assert tlb.hits + tlb.misses == 16
    assert 0 <= tlb.hit_rate <= 1
    with pytest.raises(IndexError):
        table.walk((64, 0))


# the collectives each arch's smoke step records on (1, 4): whisper's 4
# heads and deepseek's 8 experts fall whole to its ranks, so nothing of
# theirs is gathered apart (no reduce-scatter); whisper's vocabulary and
# MLP, cut too, gather nothing either
TRACED_KINDS = {
    "llama-3.2-vision-11b": {"all-gather", "reduce-scatter", "all-reduce"},
    "whisper-medium": {"all-reduce"},
    "deepseek-v3-671b": {"all-gather", "all-reduce"},
    "xlstm-1.3b": {"all-gather", "reduce-scatter", "all-reduce"},
    "zamba2-1.2b": {"all-gather", "reduce-scatter", "all-reduce"}}


@pytest.mark.parametrize("arch", sorted(TRACED_KINDS))
def test_other_layer_kinds_train_on_a_model_axis(arch):
    """The training forward of cross, encoder, MLA and recurrent layers
    (and zamba2's shared block, deepseek's MTP head) takes the model axis:
    the smoke cell has no gaps, and its step and backward run on ``meta``
    over an abstract (1, 4) mesh, as the dry run traces, recording the
    collectives of :data:`TRACED_KINDS` and reaching every leaf."""
    cell = specs.build_cell(
        arch, configs.ShapeSpec("train_4k", 16, 4, "train"),
        sharding.Mesh.abstract((1, 4), ("data", "model")), smoke=True,
        grad_accum=1)
    assert cell.gaps == ()
    state, b = cell.args
    with sharding.use_mesh(cell.mesh, cell.rules), \
            sharding.record_collectives() as colls:
        loss, _ = tstep.make_loss_fn(cell.cfg)(state.params, b)
        loss.backward()
    assert {c.kind for c in colls} == TRACED_KINDS[arch]
    for p in tree_lib.leaves(transformer.param_tree(state.params)):
        assert p.grad is not None and p.grad.shape == p.shape


def test_the_remat_recompute_takes_the_forward_mesh_on_another_thread():
    """On the card autograd runs the backward, and so each unit's remat
    recompute, on its device thread, where the caller's thread-local mesh
    is not active: the recompute must read the specs the forward read
    (models/transformer.py ``_in_mesh``). Here the backward runs on a
    thread of its own, on ``meta`` over an abstract (1, 4) mesh, where
    qwen2-0.5b's smoke k / v columns are half a kv head (gathered)."""
    cell = specs.build_cell(
        "qwen2-0.5b", configs.ShapeSpec("train_4k", 16, 4, "train"),
        sharding.Mesh.abstract((1, 4), ("data", "model")), smoke=True,
        grad_accum=1)
    state, b = cell.args
    with sharding.use_mesh(cell.mesh, cell.rules), \
            sharding.record_collectives():
        loss, _ = tstep.make_loss_fn(cell.cfg)(state.params, b)
    errors, colls = [], []

    def backward():
        try:
            with sharding.record_collectives() as recs:
                loss.backward()
            colls.extend(recs)
        except BaseException as e:        # re-raised below
            errors.append(e)

    thread = threading.Thread(target=backward)
    thread.start()
    thread.join()
    if errors:
        raise errors[0]
    assert {c.kind for c in colls} >= {"all-gather", "reduce-scatter",
                                       "all-reduce"}
    for p in tree_lib.leaves(transformer.param_tree(state.params)):
        assert p.grad is not None and p.grad.shape == p.shape
