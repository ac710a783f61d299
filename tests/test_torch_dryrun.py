"""launch/specs.py, launch/dryrun.py and launch/hillclimb.py.

  * A cell's arguments are one rank's shards: every leaf's bytes (weights,
    optimizer moments, step, batch, caches, cache position, in the
    reference's argument order) equal the shard shape of the reference's
    ``sharding.resolve`` spec of that leaf on the (16, 16) mesh under the
    reference's rules and ``cell_config`` overrides, for qwen2-0.5b at full
    width on its three shapes and for every arch at decode_32k.
  * ``run_cell`` on a mesh of one rank traces the port's own decode step
    of qwen2-0.5b decode_32k on ``meta`` at full width: its FLOPs equal the
    reference's analytic count to 1 %, its arguments are the card's 52.53
    GB, its temp bytes the pass's peak of created storages less the
    logits; its ``flash_decode`` FLOPs are the launches' own count, which
    the wrapper reports on ``meta`` as on the card; on the production mesh
    the same cell is traced on one rank's shards (its FLOPs times the 256
    ranks at least 99 % of the analytic count, collectives and temp
    recorded), and so are deepseek-v3-671b's, whose MLA takes its rank
    path, and xlstm-1.3b's, whose mLSTM / sLSTM take theirs; xlstm-1.3b's
    train_4k cell, whose recurrent layers now train on the model axis,
    has no gaps and is traced from passes of 2-4 periods of its loops
    (P 128, the mLSTM's chunk).
  * On the 1x1 mesh with real arguments (smoke config, on the CPU, as the
    card's one-rank check builds them) the decode step made with the
    caches' specs runs the whole model of qwen2-0.5b and of xlstm-1.3b
    and gives the logits of the step made without them.
  * A long prefill through recurrent layers, traced from passes of 2, 3
    and 4 periods and fitted, equals its whole pass (xlstm-1.3b,
    zamba2-1.2b; smoke configs), and so does a train step through them
    (xlstm-1.3b's smoke config on the production mesh).
  * A smoke-config ``hillclimb`` run with the model axis unbound traces
    the FSDP train step on the abstract (16, 16) mesh (the all-gathers and
    reduce-scatters recorded) and appends its entry to a log in
    ``tmp_path``.
  * ``repro_torch.launch.dryrun`` and ``hillclimb`` import without JAX.
"""
import json
import math
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.parallel import sharding as jsharding
from repro_torch import configs
from repro_torch.kernels.decode_attention import plain_flops
from repro_torch.launch import dryrun, hillclimb, specs
from repro_torch.parallel import sharding

SRC = Path(__file__).resolve().parents[1] / "src"


def _is_spec(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _ref_leaf_bytes(arch, shape_name, mesh_shape, monkeypatch):
    """Each argument leaf's bytes on one device of the reference's mesh:
    its abstract shape cut as ``jsharding.resolve`` binds its axes."""
    shape = jconfigs.SHAPES[shape_name]
    cfg = jspecs.cell_config(arch, shape)
    rules = dict(jsharding.DEFAULT_RULES)
    rules.update(jspecs.rule_overrides(cfg))
    monkeypatch.setattr(jsharding._CTX, "rules", rules)
    mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"),
                                                mesh_shape)))

    def shard(shape_, dtype, axes):
        spec = jsharding.resolve(axes, shape_, mesh)
        n = 1
        for i, d in enumerate(shape_):
            e = spec[i] if i < len(spec) else None
            e = () if e is None else ((e,) if isinstance(e, str) else e)
            n *= d // math.prod(mesh.shape[a] for a in e)
        return n * np.dtype(dtype).itemsize

    def tree(vals, axes):
        return [shard(v.shape, v.dtype, a) for v, a in zip(
            jax.tree_util.tree_leaves(vals),
            jax.tree_util.tree_leaves(axes, is_leaf=_is_spec))]

    B, L = shape.global_batch, shape.seq_len
    params = tree(*jspecs.abstract_params(cfg))
    tok = shard((B, 1 if shape.step == "decode" else L), np.int32,
                ("batch", None))
    extra = []
    if cfg.family in ("vlm", "audio") and shape.step != "decode":
        dim = cfg.cross_kv_dim if cfg.family == "vlm" else cfg.d_model
        extra = [shard((B, cfg.encoder_seq, dim), jax.numpy.bfloat16,
                       ("batch", None, None))]
    if shape.step == "train":     # state (params, m, v f32, step), batch
        moments = [b // np.dtype(np.float32).itemsize * 4 for b in params]
        batch = {"labels": tok, "tokens": tok}
        if cfg.mtp:
            batch.update(mtp_labels=tok, next_tokens=tok)
        keys = sorted(list(batch) + (["extra"] if extra else []))
        return params + moments + moments + [4] + [
            extra[0] if k == "extra" else batch[k] for k in keys]
    caches = tree(*jspecs.abstract_caches(cfg, B, L))
    return params + [tok] + caches + (extra if shape.step == "prefill"
                                      else [4])


CELLS = [("qwen2-0.5b", s) for s in ("train_4k", "prefill_32k",
                                     "decode_32k")] + \
    [(a, "decode_32k") for a in jconfigs.ARCHS if a != "qwen2-0.5b"]


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_argument_bytes_are_the_reference_s_shards(arch, shape_name,
                                                   monkeypatch):
    mesh = dryrun.mesh_of("16x16")
    cell = specs.build_cell(arch, configs.SHAPES[shape_name], mesh)
    got = [t.numel() * t.element_size()
           for t in specs.tensor_leaves(cell.args)]
    want = _ref_leaf_bytes(arch, shape_name, (16, 16), monkeypatch)
    assert got == want
    mem = specs.memory(cell)
    assert mem["argument_size_in_bytes"] == sum(want)
    donated = sum(specs.nbytes(cell.args[i]) for i in cell.donate)
    assert mem["alias_size_in_bytes"] == donated
    assert all(t.device.type == "meta"
               for t in specs.tensor_leaves(cell.args))


def test_run_cell_traces_the_decode_step_to_the_analytic_flops():
    shape = configs.SHAPES["decode_32k"]
    one = dryrun.run_cell("qwen2-0.5b", shape, "1x1", verbose=False)
    t, a = one["traced"], one["analytic"]
    assert abs(t["flops"] / a["flops"] - 1) < 0.01
    cfg = specs.cell_config("qwen2-0.5b", shape)    # the launches' count
    assert t["kernel_flops"] == {"flash_decode": cfg.n_layers() * plain_flops(
        shape.global_batch, cfg.n_heads, shape.seq_len, cfg.hd, 512)}
    assert t["collective"]["total"] == 0 and one["chips"] == 1
    assert one["memory"]["argument_size_in_bytes"] == 52527673604
    mem = one["memory"]
    assert 0 < mem["temp_size_in_bytes"] < 2**30    # ATen's and kernels'
    assert t["scratch_peak_bytes"] > 0
    assert mem["total_per_device"] == mem["argument_size_in_bytes"] + \
        mem["output_size_in_bytes"] - mem["alias_size_in_bytes"] + \
        mem["temp_size_in_bytes"]
    assert t["peak_bytes"] == mem["temp_size_in_bytes"] + \
        mem["output_size_in_bytes"] - mem["alias_size_in_bytes"]
    assert one["roofline"]["dominant"] == "memory"
    assert one["roofline_chip"].startswith("H100")
    prod = dryrun.run_cell("qwen2-0.5b", shape, "16x16", verbose=False)
    pt = prod["traced"]
    assert pt is not None and "traced_null" not in prod
    assert prod["roofline"]["collective_s"] is not None
    assert prod["memory"]["temp_size_in_bytes"] is not None
    assert pt["collective"]["total"] > 0
    # every rank's share of the step, summed, is the step: the excess over
    # the analytic count is the work the ranks of a line repeat (the
    # norms, the logits' head over the gathered hidden state, the kv heads
    # each rank of the sequence line attends)
    assert pt["flops_all_chips"] >= 0.99 * a["flops"], (pt, a)
    print(f"qwen2-0.5b decode_32k on 16x16: traced x 256 / analytic = "
          f"{pt['flops_all_chips'] / a['flops']:.4f}")
    assert prod["analytic"] == a
    xl = dryrun.run_cell("xlstm-1.3b", shape, "16x16", verbose=False)
    assert "traced_null" not in xl and xl["traced"]["collective"]["total"] > 0
    assert xl["memory"]["temp_size_in_bytes"] is not None
    train = specs.build_cell("xlstm-1.3b", configs.SHAPES["train_4k"],
                             dryrun.mesh_of("16x16"))
    assert train.gaps == () and specs._fit_period(train) == 128
    ds = dryrun.run_cell("deepseek-v3-671b", shape, "16x16", verbose=False)
    assert "traced_null" not in ds and ds["traced"]["collective"]["total"] > 0
    assert ds["memory"]["temp_size_in_bytes"] is not None


@pytest.mark.parametrize("arch,shape_name", [("qwen2-0.5b", "decode_32k"),
                                             ("xlstm-1.3b", "long_500k")])
def test_one_rank_cell_runs_its_step_on_real_arguments(arch, shape_name):
    """``build_cell`` on the 1x1 mesh with real arguments (what the card's
    one-rank check runs, outside any ``use_mesh``; smoke config, B 2, S
    16): the step made with the caches' specs runs the whole model and
    gives the logits of the same step made without them."""
    import torch
    from repro_torch.train import step as steps
    shape = configs.ShapeSpec(shape_name, 16, 2, "decode")
    cell = specs.build_cell(arch, shape, dryrun.mesh_of("1x1"),
                            device="cpu", seed=0, smoke=True)
    model, tok, caches, pos = cell.args
    want = steps.make_decode_step(cell.cfg)(
        model, tok, jax.tree_util.tree_map(torch.clone, caches), pos)[0]
    got = cell.fn(*cell.args)[0]
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,mesh_name,L", [("xlstm-1.3b", "16x16", 160),
                                              ("zamba2-1.2b", "16x16", 10240),
                                              ("zamba2-1.2b", "1x1", 10240)])
def test_recurrent_prefill_fit_equals_the_whole_trace(arch, mesh_name, L):
    """``trace_cell`` of a prefill through recurrent layers fits its counts
    from passes of 2, 3 and 4 periods: on the smoke configs (zamba2's Mamba2
    chunk raised to 512 so that the whole pass traces quickly; its shared
    attention's causal walk makes its FLOPs quadratic) the fit equals the
    whole pass in FLOPs, the kernels' own, bytes, every collective and both
    peaks."""
    import dataclasses

    over = None
    if arch == "zamba2-1.2b":
        over = dict(mamba=dataclasses.replace(
            configs.get_smoke_config(arch).mamba, chunk=512))
    mesh = dryrun.mesh_of(mesh_name)

    def cell(n):
        return specs.build_cell(arch, configs.ShapeSpec("prefill_32k", n, 2,
                                                        "prefill"),
                                mesh, cfg_over=over, smoke=True)

    specs.trace_cell(cell(64))       # a process's first pass: one-time ops
    whole = cell(L)
    P = specs._fit_period(whole)
    assert P and L // P == 5, P
    fit, want = specs.trace_cell(whole), specs._traced(whole)
    assert fit.flops == want.flops and fit.kernel_flops == want.kernel_flops
    assert fit.bytes == want.bytes
    assert [(c.kind, c.nbytes, c.group) for c in fit.collectives] == \
        [(c.kind, c.nbytes, c.group) for c in want.collectives]
    assert (fit.peak_bytes, fit.scratch_peak_bytes) == \
        (want.peak_bytes, want.scratch_peak_bytes)
    assert (fit.kernel_flops != {}) == (arch == "zamba2-1.2b")


def test_hillclimb_traces_the_fsdp_step_on_the_abstract_mesh(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path / "dryrun"))
    log = tmp_path / "perf_log.json"
    argv = ["--arch", "qwen2-0.5b", "--shape", "train_4k", "--smoke",
            "--tag", "fsdp-only", "--hypothesis", "model axis unbound",
            "--set", "q_chunk=4096", "--set", "kv_chunk=4096",
            "--log", str(log)]
    for r in ("heads_tp", "kv_heads_tp", "mlp_tp", "vocab_tp"):
        argv += ["--rule", f"{r}="]
    entry = hillclimb.main(argv)
    saved = json.loads(log.read_text())
    assert saved[-1]["tag"] == "fsdp-only" and saved[-1]["after"] == \
        entry["after"]
    after = entry["after"]
    assert after["traced_null"] is None and after["coll_per_dev_bytes"] > 0
    assert after["chips"] == 256 and after["dominant"] in (
        "compute", "memory", "collective")
    cell = specs.build_cell(
        "qwen2-0.5b", configs.SHAPES["train_4k"], dryrun.mesh_of("16x16"),
        smoke=True, cfg_over={"q_chunk": 4096, "kv_chunk": 4096},
        rules_over={r: None for r in ("heads_tp", "kv_heads_tp", "mlp_tp",
                                      "vocab_tp")})
    kinds = {r.kind for r in specs.trace_cell(cell).collectives}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    assert sharding.current_mesh() is None
    hillclimb.main(argv + ["--mesh", "one"])
    assert len(json.loads(log.read_text())) == 2


def test_dryrun_cli_writes_records_and_imports_no_jax(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    dryrun.main(["--arch", "xlstm-1.3b", "--shape", "long_500k", "--mesh",
                 "both"])
    for mesh in ("16x16", "2x16x16"):
        rec = json.loads((tmp_path / f"xlstm-1.3b__long_500k__{mesh}.json")
                         .read_text())
        assert set(rec) >= {"memory", "analytic", "roofline", "traced"}
        assert rec["traced"] is not None or rec["traced_null"]["leaf"]
    assert "xlstm-1.3b" not in json.loads((tmp_path / "skips.json")
                                          .read_text())
    code = ("import sys; import repro_torch, repro_torch.launch.dryrun, "
            "repro_torch.launch.hillclimb; "
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))], 'jax loaded'")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(SRC),
                                       "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_recurrent_train_fit_equals_the_whole_trace():
    """``trace_cell`` of a train step through recurrent layers fits its
    counts from passes of 2, 3 and 4 periods of its loops, as a prefill's
    (xlstm-1.3b's train_4k trace, its sLSTMs stepping 4096 tokens, passed
    12 minutes whole): on xlstm-1.3b's smoke config (P 32, the mLSTM's
    chunk) at 5 periods on the production mesh (the model axis on the
    rank's shards under autograd) the fit equals the whole pass in FLOPs,
    bytes, every collective and both peaks."""
    mesh = dryrun.mesh_of("16x16")

    def cell(n):
        return specs.build_cell("xlstm-1.3b", configs.ShapeSpec(
            "train_4k", n, 16, "train"), mesh, smoke=True, grad_accum=1)

    specs._traced(cell(32))         # a process's first pass: one-time ops
    whole = cell(160)
    assert not whole.gaps and specs._fit_period(whole) == 32
    fit, want = specs.trace_cell(whole), specs._traced(whole)
    assert fit.flops == want.flops and fit.kernel_flops == want.kernel_flops
    assert fit.bytes == want.bytes
    assert [(c.kind, c.nbytes, c.group) for c in fit.collectives] == \
        [(c.kind, c.nbytes, c.group) for c in want.collectives]
    assert (fit.peak_bytes, fit.scratch_peak_bytes) == \
        (want.peak_bytes, want.scratch_peak_bytes)


def test_train_fit_equals_the_whole_trace():
    """``trace_cell`` of a long train step on ``meta`` (the model axis
    tensor-parallel on the production mesh) fits its counts from passes
    of 1, 2 and 3 units of each group and 2 and 3 microbatches: on
    granite-moe-3b-a800m's smoke config in two groups at 4 units each
    and 4 microbatches the fit equals the whole pass in FLOPs, the
    kernels' own, bytes, and the number and bytes of the collectives of
    each kind and group; the peaks, extrapolated, lie within 5 % of the
    whole pass's."""
    arch = "granite-moe-3b-a800m"
    pattern = configs.get_smoke_config(arch).groups[0][0]

    def cell(ga, probe):
        return specs.build_cell(
            arch, configs.ShapeSpec("train_4k", 16, 16 * ga, "train"),
            dryrun.mesh_of("16x16"), smoke=True, grad_accum=ga, probe=probe,
            cfg_over=dict(groups=((pattern, 1), (pattern, 1))))

    specs._traced(cell(1, None))     # a process's first pass: one-time ops
    cell = cell(4, {0: 4, 1: 4})
    assert not cell.gaps, cell.gaps
    fit, want = specs._fitted_train(cell), specs._traced(cell)
    assert fit.flops == want.flops and fit.kernel_flops == want.kernel_flops
    assert fit.bytes == want.bytes

    def by_kind(trace):
        out = {}
        for c in trace.collectives:
            n, b = out.get((c.kind, c.group), (0, 0))
            out[c.kind, c.group] = (n + 1, b + c.nbytes)
        return out

    assert by_kind(fit) == by_kind(want)
    assert abs(fit.peak_bytes - want.peak_bytes) <= 0.05 * want.peak_bytes
    assert fit.scratch_peak_bytes == want.scratch_peak_bytes == 0
    print(f"{arch}: peak fitted {fit.peak_bytes} B, traced "
          f"{want.peak_bytes} B")


@pytest.mark.parametrize("arch,parts", [("qwen2-0.5b", 16),
                                        ("granite-moe-3b-a800m", 1)])
def test_train_cell_logits_are_cut_over_the_vocabulary(arch, parts):
    """A train_4k rank's f32 logits of a microbatch on 16x16: qwen2-0.5b's
    vocabulary (151936) is cut 16 ways, 2.49 GB a rank against the 39.8
    GB the whole vocabulary would hold; granite's 49155 does not divide,
    so its head stays whole."""
    cell = specs.build_cell(arch, configs.SHAPES["train_4k"],
                            dryrun.mesh_of("16x16"))
    got = dryrun.logits_bytes(cell)
    rows = 256 // 16 // specs.GRAD_ACCUM.get(arch, 1)
    whole = rows * 4096 * cell.cfg.vocab * 4
    assert got == {"rank_f32": whole // parts, "whole_vocab_f32": whole,
                   "vocab_parts": parts}
    if arch == "qwen2-0.5b":
        assert (got["rank_f32"], whole) == (2_489_319_424, 39_829_110_784)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_serving_gaps_name_no_ring(shape_name):
    """gemma3-27b's cell with ``shard_kv_seq`` and the kv heads whole
    (``kv_heads_tp=None``) on the production mesh: ``kv_seq`` cuts its
    local layers' rings over their rows, which the rank path takes
    (ROADMAP 16.11b-4), so ``_serving_gaps`` names none and the cell has
    no gap."""
    mesh = dryrun.mesh_of("16x16")
    cell = specs.build_cell("gemma3-27b", configs.SHAPES[shape_name], mesh,
                            cfg_over=dict(shard_kv_seq=True),
                            rules_over=dict(kv_heads_tp=None))
    assert cell.gaps == (), cell.gaps
    missing = specs._serving_gaps(cell.cfg)
    rings = [(gi, pi) for gi, (pattern, _) in enumerate(cell.cfg.groups)
             for pi, kind in enumerate(pattern) if kind.startswith("local")]
    assert rings
    for gi, pi in rings:
        assert missing(f"caches/{gi}/{pi}/k") is None
    # the rings' rows are cut: the cache leaves' specs bind the model axis
    with sharding.use_mesh(mesh, specs.rule_overrides(cell.cfg)
                           | {"kv_heads_tp": None}):
        from repro_torch.train import step as steps
        spec = steps.rank_caches(cell.cfg, 2, 4096, mesh,
                                 device="meta")[1][rings[0][0]][rings[0][1]]
    assert "model" in str(spec["k"]), spec
