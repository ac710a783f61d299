"""Hillclimb driver: one perf iteration per invocation.

Counterpart of ``repro/launch/hillclimb.py``. Re-runs one (arch × shape)
cell of the dry run (launch/dryrun.py) with config / rule / microbatch
levers, recomputes its roofline, and appends {hypothesis, change, before,
after} to ``build/results/perf_log.json``; ``before`` is the cell's dry-run
record where one exists.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen2-0.5b \\
      --shape train_4k --tag fsdp-only \\
      --hypothesis "unbinding the model axis makes the FSDP step traceable" \\
      --rule heads_tp= --rule mlp_tp= --rule kv_heads_tp= --rule vocab_tp=
  (--rule name=            unbinds a logical axis;
   --rule name=model,data  binds to mesh axes;
   --set q_chunk=2048      config field override (moe.capacity_factor=1.0
                           replaces a nested field);
   --grad-accum 8          microbatching)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

from repro_torch import configs
from repro_torch.launch import dryrun

PERF_LOG = os.path.join(dryrun.RESULTS, "perf_log.json")


def evaluate(arch: str, shape, mesh_name: str = "16x16", cfg_over=None,
             rules_over=None, grad_accum=None, smoke: bool = False
             ) -> Dict[str, Any]:
    """The cell's memory and roofline under the levers (rounded as the
    reference's)."""
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, mesh_name, verbose=False,
                          cfg_over=cfg_over, rules_over=rules_over,
                          grad_accum=grad_accum, smoke=smoke)
    traced = rec["traced"]
    return {"trace_s": round(time.perf_counter() - t0, 1),
            "gb_per_dev": round(rec["memory"]["total_per_device"] / 1e9, 2),
            "coll_per_dev_bytes": None if traced is None else
            traced["collective"]["total"],
            "traced_null": rec.get("traced_null"),
            **{k: round(v, 6) if isinstance(v, float) else v
               for k, v in rec["roofline"].items()}}


def parse_levers(arch: str, rules, sets):
    """``--rule`` / ``--set`` strings → (rules_over, cfg_over)."""
    rules_over = {}
    for r in rules:
        name, _, val = r.partition("=")
        rules_over[name] = tuple(v for v in val.split(",") if v) or None
    cfg_over: Dict[str, Any] = {}
    nested: Dict[str, Dict[str, Any]] = {}
    for s in sets:
        k, _, v = s.partition("=")
        try:
            val = json.loads(v)
        except json.JSONDecodeError:
            val = v
        if "." in k:
            parent, _, field = k.partition(".")
            nested.setdefault(parent, {})[field] = val
        else:
            cfg_over[k] = val
    base = configs.get_config(arch)
    for parent, kv in nested.items():
        cfg_over[parent] = dataclasses.replace(getattr(base, parent), **kv)
    return rules_over, cfg_over


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "one"])
    ap.add_argument("--rule", action="append", default=[],
                    help="name=axis1,axis2 (empty = unbind)")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help="cfg field override, e.g. q_chunk=2048")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (a quick check)")
    ap.add_argument("--log", default=PERF_LOG)
    args = ap.parse_args(argv)

    rules_over, cfg_over = parse_levers(args.arch, args.rule, args.sets)
    shape = configs.SHAPES[args.shape]
    mesh_name = dryrun.MESHES[args.mesh]
    after = evaluate(args.arch, shape, mesh_name, cfg_over=cfg_over or None,
                     rules_over=rules_over or None,
                     grad_accum=args.grad_accum, smoke=args.smoke)
    base_path = os.path.join(dryrun.RESULTS_DIR,
                             f"{args.arch}__{args.shape}__{mesh_name}.json")
    before = None
    if os.path.exists(base_path) and not args.smoke:
        with open(base_path) as f:
            b = json.load(f)
        before = {"gb_per_dev": round(b["memory"]["total_per_device"] / 1e9,
                                      2),
                  **{k: round(v, 6) if isinstance(v, float) else v
                     for k, v in b["roofline"].items()}}
    entry = {"cell": f"{args.arch}/{args.shape}/{mesh_name}",
             "tag": args.tag, "hypothesis": args.hypothesis,
             "change": {"rules": {k: list(v) if v else None
                                  for k, v in rules_over.items()},
                        "cfg": {k: (dataclasses.asdict(v)
                                    if dataclasses.is_dataclass(v) else v)
                                for k, v in cfg_over.items()},
                        "grad_accum": args.grad_accum,
                        "smoke": args.smoke},
             "before": before, "after": after, "time": time.time()}
    log = []
    if os.path.exists(args.log):
        with open(args.log) as f:
            log = json.load(f)
    log.append(entry)
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    with open(args.log, "w") as f:
        json.dump(log, f, indent=1)
    print(json.dumps(entry, indent=1))
    if before:
        print(f"\nbound: {before['bound_s']} → {after['bound_s']} s | "
              f"dominant {before['dominant']} → {after['dominant']} | "
              f"mem {before['gb_per_dev']} → {after['gb_per_dev']} GB/dev")
    return entry


if __name__ == "__main__":
    main()
