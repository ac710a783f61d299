"""AutoDMA (paper §3.2, Fig. 7) live on the port: unmodified vs AutoDMA vs
handwritten tiles, through the hand-written builder kernel on the card
(the plain grid walk on the CPU), with the planner's DMA accounting.

  python examples/autodma_demo_torch.py                # on the card
  python examples/autodma_demo_torch.py --device cpu   # plain PyTorch

The counterpart of examples/autodma_demo.py through ``repro_torch``
alone. The L1 budget is the JAX demo's 256 KiB, capped at what a block's
shared memory holds on the card, and the handwritten tiles are the card's
expert tiles (launch/kernel_suite.py ``HANDWRITTEN_TILES``; the JAX demo's
128 x 128 x 512 are the TPU's and overflow a block's shared memory).
``main`` returns one row a mode.
"""
import argparse
import os
import sys
import time

if __name__ == "__main__":      # run as a file: find the package
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import heromem  # noqa: E402
from repro_torch.kernels import gemm as gemm_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.kernel_suite import HANDWRITTEN_TILES  # noqa: E402
from repro_torch.serve.engine import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--size", type=int, default=512,
                    help="M = N = K of the gemm")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    M = N = K = args.size
    g = torch.Generator().manual_seed(0)
    A = torch.randn(M, K, generator=g).to(device)
    B = torch.randn(K, N, generator=g).to(device)
    # a small L1 so that tiling is not trivial at this size
    budget = min(256 * 1024, heromem.SMEM_PER_BLOCK - heromem.SMEM_RESERVE)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    print(f"gemm {M}x{N}x{K} on {device}, L1 budget {budget // 1024} KiB")
    print(f"{'mode':12s} {'tiles':>18s} {'L1':>9s} {'traffic':>9s} "
          f"{'bursts':>7s} {'wall(ms)':>9s} {'max|err|':>9s}")
    exp = ref.gemm(A.cpu().double(), B.cpu().double())
    rows = []
    runs = [(mode, dict(mode=mode)) for mode in
            ("unmodified", "paper", "autodma")]
    runs.append(("handwritten", dict(handwritten_tiles=HANDWRITTEN_TILES)))
    for name, kw in runs:
        gemm_mod.gemm(A, B, budget=budget, **kw)      # build, first call
        sync()
        t0 = time.perf_counter()
        out, plan = gemm_mod.gemm(A, B, budget=budget, **kw)
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        err = float((out.cpu().double() - exp).abs().max())
        rows.append(dict(mode=name, tiles=plan.tiles, ms=dt, max_abs_err=err))
        print(f"{name:12s} {str(plan.tiles):>18s} "
              f"{plan.vmem_bytes // 1024:>8d}K "
              f"{plan.traffic_bytes // 1024:>8d}K {plan.dma_bursts:>7d} "
              f"{dt:>9.2f} {err:>9.1e}")
    print("\nAutoDMA needs no change to the kernel's body; handwritten needs "
          "explicit tiles and index maps (the paper's 2.6x LOC cost).")
    return rows


if __name__ == "__main__":
    main()
