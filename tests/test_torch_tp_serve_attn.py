"""The serving steps of cross, encoder and MLA layers on a rank's shards
(models/attention.py ``cross_forward`` / ``encoder_forward`` /
``mla_forward`` with their specs, models/transformer.py ``encode`` on a
rank) against the JAX package's partitioned steps.

The f32 smoke configs of llama-3.2-vision-11b (four GQA layers and a
cross layer over 16 stub patches), whisper-medium (the encoder over 16
stub frames, then self and cross layers) and deepseek-v3-671b (MLA, one
dense and two MoE layers), every norm and bias perturbed so that a slice
of each shows, under the rules of their production decode cell
(``launch/specs.rule_overrides`` of ``cell_config(arch, decode_32k)``:
``kv_seq`` → model for llama-vision, whose 8 kv heads do not cover the
model axis of 16, and for deepseek's latents; whisper's 16 kv heads take
the model axis), on the meshes (data 2, model 2), (1, 4) and (1, 8); 4
slots × 32 rows:

  * a prefill of 6 tokens with the encoder input ``extra`` [4, 16, 64],
    then decode steps at positions 6 and 7: llama-vision's self and cross
    caches and deepseek's latents are cut over their rows, so the later
    slices of the self caches and latents are empty (the lse and
    ``combine_partials``);
  * a decode step at position 12 over caches drawn N(0, 1) (the second
    slice of (2, 2) empty, the last two of (1, 4), the last four of
    (1, 8)).

Splits covered: the cross and encoder projections on head boundaries at
model 2 and 4 and in halves of a head at 8; deepseek's ``w_uq`` / ``w_uk``
/ ``w_uv`` in halves of a head at 8 (gathered first); whisper's GELU MLP
with ``b_in`` over the model axis, in the encoder too; deepseek's experts
on the MoE's mesh paths; the FSDP gather over data at (2, 2).

The JAX side runs ``make_prefill_step`` / ``make_decode_step`` jitted on an
8-device CPU mesh with ``Auto`` axes, in a subprocess, from the same
weights, encoder input and caches; each step's caches are put back on
their shardings (``jax.device_put``: a step may hand
the cross caches back on a sharding GSPMD chose, which the next step's
jit refuses). The port's ranks run the same steps
(parallel/mesh_jobs.py ``serve_job``), one spawn of gloo ranks a mesh.
Each rank's logits (its rows, the whole vocabulary) and cache parts within
1e-5 of the largest reference value, and the collectives of its decode
step equal to the dry run's trace of the same cell.

Besides, the dry run's temp: ``flash_decode`` on ``meta`` reports the
split partials its launch would allocate, and ``specs.memory`` counts the
bytes alive at that launch.
"""
import dataclasses
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
from repro_torch.core import perf
from repro_torch.kernels import decode_attention as tda
from repro_torch.launch import dryrun, specs
from repro_torch.parallel import launch, sharding
from repro_torch.parallel.mesh_jobs import ServeJob, each, serve_job
from repro_torch.train import step as step_lib

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("llama-3.2-vision-11b", "whisper-medium", "deepseek-v3-671b")
MESHES = ((2, 2), (1, 4), (1, 8))
B, S, L = 4, 32, 6
FILL_POS = 12
TOL = 1e-5
PERTURBED = ("scale", "bias", "bq", "bk", "bv", "b_in", "b_out")

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
        p_sh = shlib.tree_shardings(c["axes"], shapes(params), mesh)
        c_axes = transformer.cache_logical_axes(cfg)
        tok_sh = shlib.named_sharding(("batch", None), (c["B"], 1), mesh)
        pre_sh = shlib.named_sharding(("batch", None), c["prompt"].shape,
                                      mesh)
        ex_sh = shlib.named_sharding(("batch", None, None),
                                     c["extra"].shape, mesh) \
            if c["extra"] is not None else None
        def run(caches, prompt, decode):
            c_sh = shlib.tree_shardings(c_axes, shapes(caches), mesh)
            logits = []
            if prompt is not None:
                f = jax.jit(steps.make_prefill_step(cfg),
                            in_shardings=(p_sh, pre_sh, c_sh, ex_sh))
                extra = None if c["extra"] is None else \
                    jnp.asarray(c["extra"])
                lg, caches = f(params, jnp.asarray(prompt), caches, extra)
                logits.append(np.asarray(lg))
                caches = jax.device_put(caches, c_sh)
            f = jax.jit(steps.make_decode_step(cfg),
                        in_shardings=(p_sh, tok_sh, c_sh,
                                      NamedSharding(mesh, P())))
            for tok, pos in decode:
                lg, caches = f(params, jnp.asarray(tok), caches,
                               jnp.asarray(pos, jnp.int32))
                logits.append(np.asarray(lg))
                caches = jax.device_put(caches, c_sh)
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
    bias (layer norms', the projections' and the GELU MLP's) moved off its
    init by N(0, 0.1²) so that each slice of them reaches the output; and
    the axes tree."""
    vals, axes = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(seed), cfg))
    vals = jax.tree_util.tree_map(np.asarray, vals)
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(vals)
    out = []
    for path, a in flat:
        name = str(path[-1])
        if any(k in name for k in PERTURBED):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return jax.tree_util.tree_unflatten(tdef, out), axes


def _cell_rules(arch):
    cell = specs.cell_config(arch, configs.SHAPES["decode_32k"])
    return cell.shard_kv_seq, specs.rule_overrides(cell)


def _seq_axis(spec):
    """The sequence axis of a cache leaf's spec: K/V [layers, batch, K, S,
    hd], MLA's latents [layers, batch, S, c]."""
    return 3 if len(spec) == 5 else 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on the JAX side (one subprocess) while the port's ranks
    run them (one spawn a mesh)."""
    d = tmp_path_factory.mktemp("tp_serve_attn")
    rng = np.random.default_rng(1)
    cases, jobs = {}, {m: [] for m in MESHES}
    for i, arch in enumerate(ARCHS):
        kv_seq, rules = _cell_rules(arch)
        jcfg = jconfigs.get_smoke_config(arch, compute_dtype=jax.numpy.float32,
                                         shard_kv_seq=kv_seq)
        cfg = configs.get_smoke_config(arch, compute_dtype=torch.float32,
                                       shard_kv_seq=kv_seq)
        params, axes = _perturbed(jcfg, 10 + i)
        prompt = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
        extra = None
        if cfg.encoder_seq:
            dim = cfg.cross_kv_dim if cfg.family == "vlm" else cfg.d_model
            extra = rng.standard_normal(
                (B, cfg.encoder_seq, dim)).astype(np.float32)
        decode = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32), p)
                  for p in (L, L + 1)]
        fill_decode = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
                        FILL_POS)]
        zero = jtransformer.init_caches(jcfg, B, S)
        fill = [rng.standard_normal(a.shape).astype(np.float32)
                for a in jax.tree_util.tree_leaves(zero)]
        for mesh in MESHES:
            cases[(arch, mesh)] = dict(
                params=params, axes=axes, rules=rules, kv_seq=kv_seq, B=B,
                S=S, prompt=prompt, extra=extra, decode=decode, fill=fill,
                fill_decode=fill_decode)
            jobs[mesh].append(ServeJob(cfg=cfg, mesh=mesh, rules=rules,
                                       batch=B, max_seq=S, prompt=prompt,
                                       extra=extra, decode=decode,
                                       weights=params))
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


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", ("steps", "fill"))
def test_rank_steps_equal_the_partitioned_reference(arch, mesh, run,
                                                    results):
    ref, ours, cases = results
    j_logits, j_caches = ref[(arch, mesh)][run]
    ranks = ours[(arch, mesh)][0 if run == "steps" else 1]
    c = cases[(arch, mesh)]
    cfg = configs.get_smoke_config(arch, compute_dtype=torch.float32,
                                   shard_kv_seq=c["kv_seq"])
    amesh = sharding.Mesh.abstract(mesh, ("data", "model"))
    with sharding.use_mesh(amesh, c["rules"]):
        specs_leaves = jax.tree_util.tree_leaves(
            step_lib.rank_caches(cfg, B, S, amesh, device="meta")[1],
            is_leaf=_is_spec)
    cut_rows = [spec[_seq_axis(spec)] is not None and
                cfg.encoder_seq != want.shape[_seq_axis(spec)]
                for spec, want in zip(specs_leaves, j_caches)]
    saw_empty = False
    for r in ranks:
        lo, hi = r["rows"]
        assert len(r["logits"]) == len(j_logits)
        for k, (got, want) in enumerate(zip(r["logits"], j_logits)):
            _close(got, want[lo:hi], f"{arch} {mesh} {run} rank "
                   f"{r['coords']} logits of step {k}")
        for i, (got, want, spec) in enumerate(zip(r["caches"], j_caches,
                                                  specs_leaves)):
            part = sharding.shard_slices(want.shape, spec, amesh,
                                         amesh.rank_at(r["coords"]))
            _close(got, want[part], f"{arch} {mesh} {run} rank "
                   f"{r['coords']} cache leaf {i}")
            if cut_rows[i]:
                last = L + 1 if run == "steps" else FILL_POS
                saw_empty |= part[_seq_axis(spec)].start > last
        assert r["launches"] == {"flash_decode": 0, "flash_attention": 0}
    if any(cut_rows):
        assert saw_empty, "no rank held an empty slice of the cache's rows"


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


def test_meta_flash_decode_reports_its_scratch_and_memory_counts_it():
    """``flash_decode`` on ``meta`` walks nothing: it reports the split
    partials its launch would allocate on an H100 (``part_ml`` +
    ``part_acc``, f32) and the plain version's FLOPs, with its output (and
    lse) alive beside them; ``specs.memory`` takes the bytes alive at that
    launch into temp when they pass the storages' own peak."""
    Bq, H, K, Sq, hd = 8, 14, 2, 4096, 64
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(Bq, H, hd, **meta)
    kc, vc = torch.empty(Bq, K, Sq, hd, **meta), torch.empty(Bq, K, Sq, hd,
                                                             **meta)
    lens = torch.empty(Bq, dtype=torch.int32, device="meta")
    plan = tda.decode_launch(Bq, H, K, Sq, hd, perf.H100.sms)
    scratch = 4 * (plan.part_ml + plan.part_acc)
    assert plan.nsplit > 1 and scratch > 0
    with perf.TraceCount() as count:
        out, lse = tda.flash_decode(q, kc, vc, lens, return_lse=True)
    assert out.shape == q.shape and lse.shape == (Bq, H)
    assert count.kernel_scratch == {"flash_decode": scratch}
    assert count.kernel_flops == {"flash_decode": tda.plain_flops(
        Bq, H, Sq, hd, tda.decode_block_k(Sq, 512))}
    assert count.aten_flops == 0
    assert count.scratch_peak_bytes == scratch + 2 * q.numel() + 4 * Bq * H
    cell = specs.build_cell("qwen2-0.5b", configs.ShapeSpec(
        "decode_32k", 64, 4, "decode"), dryrun.mesh_of("1x1"), smoke=True)
    tr = specs.trace_cell(cell)
    assert tr.scratch_peak_bytes > 0 and tr.kernel_flops["flash_decode"] > 0
    out_new = specs.memory(cell)["output_size_in_bytes"] - \
        specs.memory(cell)["alias_size_in_bytes"]
    assert specs.memory(cell, tr)["temp_size_in_bytes"] == max(
        tr.peak_bytes, tr.scratch_peak_bytes) - out_new
    above = dataclasses.replace(tr, scratch_peak_bytes=tr.peak_bytes + 4096)
    assert specs.memory(cell, above)["temp_size_in_bytes"] == \
        tr.peak_bytes + 4096 - out_new
