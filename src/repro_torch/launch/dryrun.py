"""Dry run: every (arch × shape) cell on the production meshes, (16, 16)
single-pod and (2, 16, 16) multi-pod, with no card.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell for 256 or 512 fake devices and reads XLA's memory
and cost analyses; the port runs one process a rank, so a cell is ONE
rank's arguments (launch/specs.py: ``meta`` tensors at their shard shapes
under the reference's sharding rules) and, where the port has the path,
one traced pass of the port's own step on them. Per cell:

  * ``memory`` — a rank's argument, output and alias bytes, exact from
    the shard shapes (launch/specs.py ``memory``: the donated arguments
    are the alias); temp bytes from the traced pass (the storages it
    created, followed to their last tensor, and the scratch each
    hand-written kernel's launch allocates for itself, reported by its
    ``meta`` branch: ``scratch_peak_bytes``), ``null`` where nothing is
    traced; ``chip_smoke.py`` phase 11b measures one step's temp on the
    card and gates the traced temp against it;
  * ``analytic`` — launch/accounting.py ``step_cost`` (whole step);
  * ``traced`` — one rank's FLOPs (``FlopCounterMode`` over the ATen ops,
    and the attention kernels' own counts, which their wrappers report on
    ``meta`` without walking, as their launches do on the card), the
    bytes its ATen ops touch unfused (a kernel's are not seen, on the
    card as on ``meta``), and the collectives the port's code issued
    (parallel/sharding.py records them on the abstract mesh) through
    core/perf.py's ring model. A serving cell's pass is one rank's step
    on its shards (the model axis tensor- and sequence-parallel:
    ``transformer.hidden``), so ``flops_all_chips`` also counts the
    work the ranks of a line repeat; so does a train cell's, its step on
    the rank's shards under autograd (``transformer.train_forward``,
    every layer kind). The eager pass visits every layer,
    so the reference's probe lowerings (which make up for XLA counting a
    scanned body once) are not ported; a prefill through recurrent
    layers, whose loops step a chunk or a token at a time, is traced at
    2, 3 and 4 periods of its loops and fitted (``specs.trace_cell``:
    the counts exact, the peaks extrapolated), and so is a train step of
    more than ``specs.TRAIN_FIT_PASSES`` layer passes, from passes of 1-3
    units and 2-3 microbatches. Where the cell's rules need a path the
    port lacks (``specs.Cell.gaps``: a ring cache cut over its rows),
    ``traced`` is
    ``null`` and ``traced_null`` names the leaf and the rule: no other
    mesh is substituted and no bytes are invented;
  * ``roofline`` — core/perf.py ``Roofline`` on the H100's datasheet peaks
    from the analytic FLOPs and bytes and the traced collective bytes
    (the collective term ``null`` where ``traced`` is). Modelled, not
    measured.

"Compiles" becomes "the traced pass runs". ``--mesh one`` is a mesh of one
rank (the whole step, every cell traceable): the one-card check's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Results: build/results/dryrun/<arch>__<shape>__<mesh>.json (cached; --force
reruns), build/results/dryrun/skips.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

from repro_torch import configs
from repro_torch.core import perf
from repro_torch.launch import accounting, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import Mesh

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "build", "results")
RESULTS_DIR = os.path.join(RESULTS, "dryrun")
MESHES = {"single": "16x16", "multi": "2x16x16", "one": "1x1"}


def mesh_of(name: str) -> Mesh:
    """``16x16``, ``2x16x16`` (the production meshes) or ``1x1``."""
    if name == "1x1":
        return Mesh.abstract((1, 1), ("data", "model"))
    return make_production_mesh(multi_pod=name == "2x16x16")


def traced_record(cell: specs.Cell, tr) -> Dict:
    coll = perf.collective_bytes(tr.collectives)
    return {"flops": tr.flops, "flops_all_chips": tr.flops * cell.mesh.size,
            "kernel_flops": tr.kernel_flops, "bytes": tr.bytes,
            "peak_bytes": tr.peak_bytes,
            "scratch_peak_bytes": tr.scratch_peak_bytes,
            "collective": {k: v for k, v in coll.items() if k != "counts"},
            "collective_counts": coll["counts"], "trace_s": tr.seconds}


def logits_bytes(cell: specs.Cell) -> Dict[str, int]:
    """A train cell's f32 logits of one microbatch on a rank (the loss
    takes them at f32): over the rank's part of the vocabulary where the
    head is cut over it (``vocab_tp``), and as the whole vocabulary would
    hold them."""
    cfg, params = cell.cfg, cell.in_shardings[0].params
    spec, dim = (params["embed"].spec, 0) if cfg.tie_embeddings else \
        (params["lm_head"].spec, 1)
    entry = spec[dim] if dim < len(spec) else None
    parts = sharding.axis_size(sharding._entry_axes(entry), cell.mesh)
    rows = cell.args[1]["tokens"].shape[0] // cell.grad_accum
    whole = rows * cell.shape.seq_len * cfg.vocab * 4
    return {"rank_f32": whole // parts, "whole_vocab_f32": whole,
            "vocab_parts": parts}


def run_cell(arch: str, shape: configs.ShapeSpec, mesh_name: str = "16x16",
             verbose: bool = True, **levers) -> Dict:
    """One cell's record on ``mesh_name``; ``levers``: build_cell's
    ``cfg_over`` / ``rules_over`` / ``grad_accum`` / ``smoke``."""
    mesh = mesh_of(mesh_name)
    chips = mesh.size
    rec: Dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                 "chips": chips}
    cell = specs.build_cell(arch, shape, mesh, **levers)
    tr = None
    if cell.gaps:
        rec["traced"] = None
        rec["traced_null"] = {"leaf": cell.gaps[0],
                              "leaves": len(cell.gaps)}
    else:
        tr = specs.trace_cell(cell)
        rec["traced"] = traced_record(cell, tr)
    rec["memory"] = specs.memory(cell, tr)
    if shape.step == "train":
        rec["logits"] = logits_bytes(cell)
    cost = accounting.step_cost(cell.cfg, shape)
    coll = None if tr is None else \
        rec["traced"]["collective"]["total"] * chips
    rl = perf.Roofline(flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                       coll_bytes=coll, chips=chips,
                       model_flops=cost.model_flops)
    rec["analytic"] = {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
                       "params_total": cost.params_total,
                       "params_active": cost.params_active}
    rec["roofline"] = rl.as_dict()
    rec["roofline_chip"] = rl.chip.name
    if verbose:
        m = rec["memory"]
        t = rec["traced"]
        x = "null" if rl.collective_s is None else f"{rl.collective_s:.4f}"
        print(f"[{arch} × {shape.name} × {mesh_name}] "
              f"{m['total_per_device'] / 1e9:.2f} GB/rank (args "
              f"{m['argument_size_in_bytes'] / 1e9:.2f}) | traced "
              + (f"{t['flops_all_chips']:.4g} flop vs analytic "
                 f"{cost.flops:.4g}" if t else "null")
              + f" | terms c/m/x = {rl.compute_s:.4f}/{rl.memory_s:.4f}/{x}"
              f" s → {rl.dominant}", flush=True)
    return rec


def cell_path(arch: str, shape_name: str, mesh_name: str) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh_name}.json")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "one"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        cells = configs.all_cells()
    else:
        archs = [args.arch] if args.arch else list(configs.ARCHS)
        for a in archs:
            for s in configs.cells(a):
                if args.shape and s.name != args.shape:
                    continue
                cells.append((a, s))

    meshes = (["16x16", "2x16x16"] if args.mesh == "both"
              else [MESHES[args.mesh]])
    failures = []
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mesh_name in meshes:
            path = cell_path(arch, shape.name, mesh_name)
            if os.path.exists(path) and not args.force:
                print(f"[skip cached] {arch} × {shape.name} × {mesh_name}")
                continue
            try:
                rec = run_cell(arch, shape, mesh_name)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            except Exception as e:
                failures.append((arch, shape.name, mesh_name, repr(e)))
                print(f"[FAIL] {arch} × {shape.name} × {mesh_name}: {e}")
                traceback.print_exc()
    skips = {a: configs.skipped_cells(a) for a in configs.ARCHS
             if configs.skipped_cells(a)}
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, "skips.json"), "w") as f:
        json.dump(skips, f, indent=1)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print(" ", f_)
        raise SystemExit(1)
    print(f"\ndry-run complete ({time.perf_counter() - t0:.1f} s).")


if __name__ == "__main__":
    main()
