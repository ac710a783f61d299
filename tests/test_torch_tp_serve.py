"""The serving steps on a rank's shards (train/step.py ``shard_model`` /
``rank_caches``, models/transformer.py ``hidden``, models/attention.py
``gqa_forward`` with its specs) against the JAX package's partitioned
steps.

The f32 smoke configs of qwen2-0.5b, minitron-4b, granite-moe-3b-a800m and
gemma3-27b (every bias and norm perturbed, so that a slice of each shows),
with the rules of their production decode cell (``launch/specs.
rule_overrides`` of ``cell_config(arch, decode_32k)``: ``kv_seq`` → model
for all but gemma3-27b, whose 16 kv heads cover the model axis), on the
meshes (data 2, model 2), (1, 4) and (1, 8); 4 slots × 32 rows:

  * a prefill of 6 tokens, then decode steps at positions 6 and 7: under
    ``kv_seq`` the cache's rows are cut 8 or 4 a rank, so the later
    slices are empty (flash_decode's lse and ``combine_partials``);
  * a decode step at position 20 over caches drawn N(0, 1) (slice 3 of
    (1, 4) empty, later ones of (1, 8));

Splits covered: qwen2's q columns are whole heads at model 4 and half a
head at model 8, its k / v columns half a kv head at 4; gemma3's heads
split on head boundaries at (2, 2), in halves at (1, 8); the FSDP gather
over data at (2, 2); granite's experts on the slot-parallel path.

The JAX side runs ``make_prefill_step`` / ``make_decode_step`` jitted on an
8-device CPU mesh with ``Auto`` axes (the installed JAX's ``jax.make_mesh``
gives ``Explicit`` ones, which the reference's sharding refuses: ROADMAP
§3), in a subprocess, from the same weights and caches; the port's ranks
run the same steps (parallel/mesh_jobs.py ``serve_job``), one spawn of
gloo ranks a mesh. Each rank's logits (its rows, the whole vocabulary) and
cache parts (its slots, kv heads and rows of the reference's final caches)
within 1e-5 of the largest reference value (the order of the sums).

gemma3-27b's sliding-window rings cut over their rows (ROADMAP 16.11b-4):
its smoke config with ``shard_kv_seq`` and ``kv_heads_tp=None`` (the kv
heads whole, so ``kv_seq`` binds every cache's rows, the 8-row rings'
too) on (1, 4) and (2, 2): a prefill of 6 tokens (L ≤ W: the reference's
ring prefill scatters L > W keys into colliding rows, ROADMAP §3), then
decode steps at positions 6-13, past the ring's wrap at 8; and a decode at
position 20 over caches drawn N(0, 1). The same 1e-5 gate, and the
collectives against the dry run's trace of the same cell.

Besides: ``flash_decode_plain``'s lse against ``torch.logsumexp`` of the
masked logits, with an empty slot; ``combine_partials`` of two halves of
a cache equal to the whole call (the kernel's lse on the card:
tests/test_torch_decode_split.py, which imports no JAX).
"""
import math
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
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.kernels import decode_attention as tda
from repro_torch.launch import specs
from repro_torch.parallel import launch, sharding
from repro_torch.parallel.mesh_jobs import ServeJob, each, serve_job
from repro_torch.train import step as step_lib

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("qwen2-0.5b", "minitron-4b", "granite-moe-3b-a800m", "gemma3-27b")
MESHES = ((2, 2), (1, 4), (1, 8))
B, S, L = 4, 32, 6
FILL_POS = 20
TOL = 1e-5
# the ring case (16.11b-4): gemma3-27b's rings cut over their rows
RING = ("gemma3-27b", "ring")
RING_MESHES = ((1, 4), (2, 2))
RING_RULES = {"kv_seq": ("model",), "kv_heads_tp": None}
RING_DECODE = tuple(range(L, L + 8))        # past the wrap at W = 8

SCRIPT = r"""
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.models import transformer
from repro.parallel import sharding as shlib
from repro.train import step as steps
cases = pickle.load(open(sys.argv[1], "rb"))
auto = jax.sharding.AxisType.Auto
tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {}
for key, c in cases.items():
    arch, shape = key[0], key[1]
    cfg = configs.get_smoke_config(arch, compute_dtype=jnp.float32,
                                   shard_kv_seq=c["kv_seq"])
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(auto, auto),
                         devices=jax.devices()[:n])
    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    res = {}
    with shlib.use_mesh(mesh, c["rules"]):
        p_sh = shlib.tree_shardings(c["axes"], jax.tree_util.tree_map(
            lambda x: tuple(x.shape), params), mesh)
        c_axes = transformer.cache_logical_axes(cfg)
        tok_sh = shlib.named_sharding(("batch", None), (c["B"], 1), mesh)
        pre_sh = shlib.named_sharding(("batch", None), c["prompt"].shape,
                                      mesh)
        def run(caches, prompt, decode):
            c_sh = shlib.tree_shardings(c_axes, jax.tree_util.tree_map(
                lambda x: tuple(x.shape), caches), mesh)
            logits = []
            if prompt is not None:
                f = jax.jit(steps.make_prefill_step(cfg),
                            in_shardings=(p_sh, pre_sh, c_sh, None))
                lg, caches = f(params, jnp.asarray(prompt), caches, None)
                logits.append(np.asarray(lg))
            f = jax.jit(steps.make_decode_step(cfg),
                        in_shardings=(p_sh, tok_sh, c_sh,
                                      NamedSharding(mesh, P())))
            for tok, pos in decode:
                lg, caches = f(params, jnp.asarray(tok), caches,
                               jnp.asarray(pos, jnp.int32))
                logits.append(np.asarray(lg))
            return logits, [np.asarray(a) for a in
                            jax.tree_util.tree_leaves(caches)]
        zero = transformer.init_caches(cfg, c["B"], c["S"])
        res["steps"] = run(zero, c["prompt"], c["decode"])
        filled = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(zero),
            [jnp.asarray(a) for a in c["fill"]])
        res["fill"] = run(filled, None, c["fill_decode"])
    out[key] = res
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _is_spec(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _perturbed(cfg, seed):
    """The reference's ``init_model`` weights (numpy), every norm scale and
    bias moved off its constant init by N(0, 0.1²) so that each slice of
    them reaches the output; and the axes tree."""
    vals, axes = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(seed), cfg))
    vals = jax.tree_util.tree_map(np.asarray, vals)
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(vals)
    out = []
    for path, a in flat:
        name = str(path[-1])
        if any(k in name for k in ("scale", "bq", "bk", "bv")):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return jax.tree_util.tree_unflatten(tdef, out), axes


def _cell_rules(arch):
    cell = specs.cell_config(arch, configs.SHAPES["decode_32k"])
    return cell.shard_kv_seq, specs.rule_overrides(cell)


def _case(rng, i, arch, kv_seq, rules, positions):
    """One arch's case: (its JAX side, its two port jobs)."""
    jcfg = jconfigs.get_smoke_config(arch, compute_dtype=jax.numpy.float32,
                                     shard_kv_seq=kv_seq)
    cfg = configs.get_smoke_config(arch, compute_dtype=torch.float32,
                                   shard_kv_seq=kv_seq)
    params, axes = _perturbed(jcfg, i)
    prompt = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    decode = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32), p)
              for p in positions]
    fill_decode = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
                    FILL_POS)]
    zero = jtransformer.init_caches(jcfg, B, S)
    fill = [rng.standard_normal(a.shape).astype(np.float32)
            for a in jax.tree_util.tree_leaves(zero)]
    case = dict(params=params, axes=axes, rules=rules, kv_seq=kv_seq, B=B,
                S=S, prompt=prompt, decode=decode, fill=fill,
                fill_decode=fill_decode)

    def jobs(mesh):
        return [ServeJob(cfg=cfg, mesh=mesh, rules=dict(rules), batch=B,
                         max_seq=S, prompt=prompt, decode=decode,
                         weights=params),
                ServeJob(cfg=cfg, mesh=mesh, rules=dict(rules), batch=B,
                         max_seq=S, decode=fill_decode, weights=params,
                         caches=fill)]
    return case, jobs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on the JAX side (one subprocess) while the port's ranks
    run them (one spawn a mesh). Keyed ``(arch, mesh)``, and ``(arch,
    mesh, "ring")`` for the ring case."""
    d = tmp_path_factory.mktemp("tp_serve")
    rng = np.random.default_rng(0)
    cases, jobs = {}, {m: [] for m in MESHES}
    for i, arch in enumerate(ARCHS):
        kv_seq, rules = _cell_rules(arch)
        case, make = _case(rng, i, arch, kv_seq, rules, (L, L + 1))
        for mesh in MESHES:
            cases[(arch, mesh)] = case
            jobs[mesh].append(((arch, mesh), make(mesh)))
    case, make = _case(rng, len(ARCHS), RING[0], True, RING_RULES,
                       RING_DECODE)
    for mesh in RING_MESHES:
        cases[(RING[0], mesh, RING[1])] = case
        jobs[mesh].append(((RING[0], mesh, RING[1]), make(mesh)))
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
            got = launch.spawn(
                each, n, (serve_job, [j for _, pair in jobs[mesh]
                                      for j in pair]),
                store_dir=str(d / f"store{n}{mesh[0]}"), backend="gloo",
                timeout_s=300.0)
            for j, (key, _) in enumerate(jobs[mesh]):
                ours[key] = ([r[2 * j] for r in got],
                             [r[2 * j + 1] for r in got])
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out + err[-3000:]
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, ours, cases


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL} x {scale:.3e}"


def _check_ranks_steps(key, run, results):
    """Each rank's logits and cache parts against the reference's → the
    caches' specs and whether some rank held an empty slice of the
    rows."""
    ref, ours, cases = results
    arch, mesh = key[0], key[1]
    j_logits, j_caches = ref[key][run]
    ranks = ours[key][0 if run == "steps" else 1]
    c = cases[key]
    kv_seq, rules = c["kv_seq"], c["rules"]
    cfg = configs.get_smoke_config(arch, compute_dtype=torch.float32,
                                   shard_kv_seq=kv_seq)
    amesh = sharding.Mesh.abstract(mesh, ("data", "model"))
    with sharding.use_mesh(amesh, rules):
        specs_leaves = jax.tree_util.tree_leaves(
            step_lib.rank_caches(cfg, B, S, amesh, device="meta")[1],
            is_leaf=_is_spec)
    saw_empty = False
    for r in ranks:
        lo, hi = r["rows"]
        assert len(r["logits"]) == len(j_logits)
        for k, (got, want) in enumerate(zip(r["logits"], j_logits)):
            _close(got, want[lo:hi], f"{key} {run} rank "
                   f"{r['coords']} logits of step {k}")
        for i, (got, want, spec) in enumerate(zip(r["caches"], j_caches,
                                                  specs_leaves)):
            part = sharding.shard_slices(want.shape, spec, amesh,
                                         amesh.rank_at(r["coords"]))
            _close(got, want[part], f"{key} {run} rank "
                   f"{r['coords']} cache leaf {i}")
            if len(spec) > 3 and spec[3] is not None:
                last = c["decode"][-1][1] if run == "steps" else FILL_POS
                saw_empty |= part[3].start > last
        assert r["launches"] == {"flash_decode": 0, "flash_attention": 0}
    return j_caches, specs_leaves, saw_empty


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", ("steps", "fill"))
def test_rank_steps_equal_the_partitioned_reference(arch, mesh, run,
                                                    results):
    _, specs_leaves, saw_empty = _check_ranks_steps((arch, mesh), run,
                                                    results)
    if any(len(spec) > 3 and spec[3] is not None for spec in specs_leaves):
        assert saw_empty, "no rank held an empty slice of the cache's rows"


def _collectives_want(arch, mesh, kv_seq, rules_over=None):
    """``launch/specs.trace_cell``'s collectives for the decode cell (B 4,
    S 32, f32) traced on ``meta`` over the abstract mesh."""
    cell = specs.build_cell(
        arch, configs.ShapeSpec("decode_32k", S, B, "decode"),
        sharding.Mesh.abstract(mesh, ("data", "model")), smoke=True,
        cfg_over=dict(compute_dtype=torch.float32,
                      param_dtype=torch.float32, shard_kv_seq=kv_seq),
        rules_over=rules_over)
    assert not cell.gaps, cell.gaps
    return [(c.kind, c.nbytes, c.group)
            for c in specs.trace_cell(cell).collectives]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_collectives_equal_the_dry_run_trace(arch, mesh, results):
    """The collectives each rank issued in its decode step over the filled
    caches (kind, bytes, group size, in order) are those
    ``launch/specs.trace_cell`` records for the same cell (B 4, S 32, f32)
    traced on ``meta`` over the abstract mesh of that shape."""
    _, ours, cases = results
    want = _collectives_want(arch, mesh, cases[(arch, mesh)]["kv_seq"])
    assert want
    for r in ours[(arch, mesh)][1]:
        assert [tuple(c) for c in r["collectives"]] == want, r["coords"]


@pytest.mark.parametrize("mesh", RING_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("run", ("steps", "fill"))
def test_ring_cut_over_its_rows_equals_the_partitioned_reference(
        mesh, run, results):
    """gemma3-27b's rings (W 8 of S 32) cut over their rows: the logits
    and each rank's ring rows within 1e-5 of the reference's partitioned
    steps, after decode steps past the wrap; a ring leaf is cut on every
    mesh, and the filled run's collectives are the dry run's."""
    key = (RING[0], mesh, RING[1])
    j_caches, specs_leaves, _ = _check_ranks_steps(key, run, results)
    W = configs.get_smoke_config(RING[0]).window
    rings = [spec for a, spec in zip(j_caches, specs_leaves)
             if a.shape[3] == W]
    assert rings and all(spec[3] is not None for spec in rings)
    assert max(p for _, p in results[2][key]["decode"]) >= W
    if run == "fill":
        want = _collectives_want(RING[0], mesh, True,
                                 {"kv_heads_tp": None})
        for r in results[1][key][1]:
            assert [tuple(c) for c in r["collectives"]] == want, \
                r["coords"]


def test_flash_decode_lse_is_the_masked_logsumexp():
    g = torch.Generator().manual_seed(0)
    Bq, H, K, Sq, hd = 3, 4, 2, 40, 16
    q = torch.randn(Bq, H, hd, generator=g)
    kc, vc = (torch.randn(Bq, K, Sq, hd, generator=g) for _ in range(2))
    lens = torch.tensor([0, 17, 40], dtype=torch.int32)
    out, lse = tda.flash_decode(q, kc, vc, lens, block_k=16,
                                return_lse=True)
    assert torch.equal(out, tda.flash_decode(q, kc, vc, lens, block_k=16))
    logits = torch.einsum("bkgd,bksd->bkgs", q.reshape(Bq, K, H // K, hd),
                          kc) / math.sqrt(hd)
    mask = torch.arange(Sq)[None] < lens[:, None]
    want = torch.logsumexp(logits.masked_fill(
        ~mask[:, None, None], -math.inf), -1).reshape(Bq, H)
    torch.testing.assert_close(lse[1:], want[1:], rtol=1e-6, atol=1e-6)
    assert lse.dtype == torch.float32
    assert bool((lse[0] == tda.NEG).all()), lse[0]       # NEG + log(S)
    torch.testing.assert_close(out[0], vc[0].mean(1).repeat_interleave(
        H // K, 0), rtol=1e-6, atol=1e-6)


def test_combine_partials_of_two_halves_is_the_whole_call():
    """Two ranks' halves of a cache's rows, each through flash_decode with
    its lse, combined as ``combine_partials`` does over a line of two
    (the gather stood in for by the two parts): the whole call's output;
    with the second half empty, the first half's; with both empty, the
    whole call's mean of V."""
    g = torch.Generator().manual_seed(1)
    Bq, H, K, Sq, hd = 4, 6, 3, 64, 16
    q = torch.randn(Bq, H, hd, generator=g)
    kc, vc = (torch.randn(Bq, K, Sq, hd, generator=g) for _ in range(2))
    lens = torch.tensor([0, 20, 32, 64], dtype=torch.int32)
    whole = tda.flash_decode(q, kc, vc, lens)
    halves = [tda.flash_decode(q, kc[:, :, i * 32:(i + 1) * 32].contiguous(),
                               vc[:, :, i * 32:(i + 1) * 32].contiguous(),
                               (lens - 32 * i).clamp(0, 32).to(torch.int32),
                               return_lse=True) for i in range(2)]

    class _Line:
        size, index = 2, 0

    parts = iter([torch.stack([h[0] for h in halves]),
                  torch.stack([h[1] for h in halves])])
    real = sharding._parts
    sharding._parts = lambda x, line: list(next(parts).unbind(0))
    try:
        got = sharding.combine_partials(halves[0][0], halves[0][1], _Line())
    finally:
        sharding._parts = real
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], halves[0][0][1], rtol=0, atol=1e-6)
