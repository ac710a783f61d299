"""Quickstart of the PyTorch/CUDA port: the hero API surface in 60 lines.

  python examples/quickstart_torch.py                 # on the card
  python examples/quickstart_torch.py --device cpu    # plain PyTorch

The counterpart of examples/quickstart.py through ``repro_torch`` alone:
the SPM capacity query, an AutoDMA plan, the planned gemm (the hand-written
``sm_90a`` builder kernel on the card, the plain grid walk on the CPU)
against the f64 oracle, a perf counter and the Fig. 7 three-way plans.
``main`` returns the gemm's error and time.
"""
import argparse
import os
import sys

if __name__ == "__main__":      # run as a file: find the package
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import autodma, heromem, perf  # noqa: E402
from repro_torch.kernels import gemm as gemm_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serve.engine import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. ask the SPM level how much fits (paper §2.4: hero_l1_capacity
    #    drives tile-size selection; on the card, a block's shared memory)
    print(f"L1 capacity: {heromem.hero_l1_capacity() / 1e3:.1f} kB")
    h = heromem.hero_l1_malloc(1 << 16)
    print(f"allocated 64 KiB as handle {h}; capacity now "
          f"{heromem.hero_l1_capacity() / 1e3:.1f} kB")
    heromem.hero_l1_free(h)

    # 2. AutoDMA: plan tiling for a matmul, with no change to the body
    spec = autodma.matmul_spec(1024, 1024, 1024)
    plan = autodma.plan(spec)
    print(f"\nAutoDMA plan: tiles={plan.tiles} grid={plan.grid} "
          f"L1={plan.vmem_bytes / 1e3:.1f} kB "
          f"traffic={plan.traffic_bytes / 1e6:.1f} MB (streaming would be "
          f"{autodma.streaming_traffic(spec) / 1e6:.0f} MB) "
          f"AI={plan.arithmetic_intensity:.0f} flops/byte")

    # 3. run the planned gemm vs the oracle (in f64)
    g = torch.Generator().manual_seed(0)
    A = torch.randn(256, 512, generator=g).to(device)
    B = torch.randn(512, 384, generator=g).to(device)
    launches = gemm_mod.gemm.launches
    C = ops.gemm(A, B, mode="autodma")
    want = ref.gemm(A.cpu().double(), B.cpu().double())
    err = float((C.cpu().double() - want).abs().max())
    rel = float((C.cpu().double() - want).norm() / want.norm())
    print(f"\ngemm on {device} vs oracle: max |err| = {err:.2e}, relative "
          f"{rel:.2e} "
          f"({gemm_mod.gemm.launches - launches} kernel launches)")

    # 4. hero perf counters
    sess = perf.PerfSession()
    c = sess.hero_perf_alloc("WALL_NS")
    sess.hero_perf_continue_all()
    ops.gemm(A, B)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sess.hero_perf_pause_all()
    ms = sess.hero_perf_read(c) / 1e6
    print(f"gemm wall time: {ms:.2f} ms (host clock, {device})")

    # 5. the paper's Fig. 7 three-way comparison, one kernel
    for mode in ("unmodified", "paper", "autodma"):
        p = autodma.plan(spec, mode=mode)
        print(f"mode={mode:11s} tiles={str(p.tiles):20s} "
              f"traffic={p.traffic_bytes / 1e6:8.1f} MB "
              f"bursts={p.dma_bursts}")
    return {"max_abs_err": err, "rel_err": rel, "ms": ms,
            "launches": gemm_mod.gemm.launches - launches}


if __name__ == "__main__":
    main()
