"""Launch-shape sweeps and a time breakdown of dense flash_decode and conv2d,
measured on the card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_sweep [--out PATH]

The figures behind the constants that ``kernels/decode_attention.py``
(``BLOCKS_PER_SM``, ``MIN_SPLIT``) and ``kernels/polybench.py``
(``CONV_BAND``) launch with, each timed as ``launch/kernel_suite.py``
times the kernels (:func:`kernel_suite.graph_ms`, 20 calls replayed from
one CUDA graph, inputs cycled past the 50 MB L2):

  * ``flash_decode`` at the serving decode shape (:data:`kernel_suite.
    DECODE`, bf16 and f32, 8 caches) for each (blocks an SM, least split)
    of :data:`DECODE_SHAPES`, the module constants set for the call;
  * the same kernel built three ways from ``csrc/decode_attention.cu``
    into a directory of its own: as it is, with the last block's merge
    cut out (every block returns after its arrival), and with everything
    cut out (a launch of the same grid that returns at once), which split
    its time into the launch, the split walk and the merge;
  * ``conv2d`` at 2048² f32 and bf16 (4 matrices) for each band of
    :data:`CONV_BANDS`.

Each timing runs three times; the rows print the card's name and power
limit beside them, and ``--out`` takes them as JSON. Without a card it
fails: there is nothing to measure on the CPU.
"""
from __future__ import annotations

import argparse
import itertools
import json
import shutil
import sys
from pathlib import Path
from typing import Callable, Dict, List

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import polybench as pb
from repro_torch.launch import kernel_suite as ks

DECODE_SHAPES = ((2, 64), (4, 64), (8, 64), (2, 256))  # (blocks an SM, keys)
CONV_BANDS = (8, 16, 32, 64, 128)
REPEATS = 3
# text edits of csrc/decode_attention.cu that cut a part of the kernel out
CUTS = {
    "as built": [],
    "merge cut out": [("  if (!last) return;\n", "  return;\n")],
    "launch only": [("  __shared__ int last;\n",
                     "  __shared__ int last;\n  if (H > 0) return;\n")],
}


def _times(fn: Callable) -> List[float]:
    return [ks.graph_ms(fn, 20) for _ in range(REPEATS)]


def _decode_inputs(dtype, g):
    B, H, K, S, hd = ks.DECODE
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
    caches = [tuple(torch.randn(B, K, S, hd, generator=g, device="cuda")
                    .to(dtype) for _ in range(2)) for _ in range(8)]
    lengths = torch.tensor(ks.decode_lengths(B, S), dtype=torch.int32,
                           device="cuda")
    return q, caches, lengths


def decode_rows(log) -> List[dict]:
    """flash_decode for each launch shape, then each cut of the kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, K, S, hd = ks.DECODE
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    saved = (da.BLOCKS_PER_SM, da.MIN_SPLIT)
    for dtype in (torch.bfloat16, torch.float32):
        q, caches, lengths = _decode_inputs(dtype, g)
        cyc = itertools.cycle(caches)
        try:
            for per_sm, least in DECODE_SHAPES:
                da.BLOCKS_PER_SM, da.MIN_SPLIT = per_sm, least
                shape = da.decode_launch(B, H, K, S, hd, n_sm)
                t = _times(lambda: da.flash_decode(q, *next(cyc), lengths))
                rows.append({"kernel": "flash_decode", "dtype": str(dtype)[6:],
                             "blocks_per_sm": per_sm, "chunk": shape.chunk,
                             "blocks": shape.blocks, "ms": t})
                log(f"flash_decode {str(dtype)[6:]} {per_sm} blocks an SM: "
                    f"{shape.nsplit} splits of {shape.chunk} keys, "
                    f"{shape.blocks} blocks: {_fmt(t)} ms")
        finally:
            da.BLOCKS_PER_SM, da.MIN_SPLIT = saved
    root = _build.BUILD_DIR / "sweep"
    try:
        for cut, edits in CUTS.items():
            src = (_build.CSRC / "decode_attention.cu").read_text()
            for old, new in edits:
                assert src.count(old) == 1, (cut, old)
                src = src.replace(old, new)
            rows += _decode_cut(cut, src, root / cut.replace(" ", "_"), log)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows


def _decode_cut(cut: str, src: str, where: Path, log) -> List[dict]:
    """Build ``src`` as the decode library in ``where`` and time it; the
    port's own build is restored afterwards."""
    (where / "csrc").mkdir(parents=True, exist_ok=True)
    (where / "csrc" / "decode_attention.cu").write_text(src)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, where / "csrc" / header.name)
    saved = (_build.CSRC, _build.BUILD_DIR, _build._LIBS.pop(
        "decode_attention", None))
    _build.CSRC, _build.BUILD_DIR = where / "csrc", where / "build"
    rows = []
    try:
        g = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.bfloat16, torch.float32):
            q, caches, lengths = _decode_inputs(dtype, g)
            cyc = itertools.cycle(caches)
            t = _times(lambda: da.flash_decode(q, *next(cyc), lengths))
            rows.append({"kernel": "flash_decode", "dtype": str(dtype)[6:],
                         "cut": cut, "ms": t})
            log(f"flash_decode {str(dtype)[6:]} {cut}: {_fmt(t)} ms")
    finally:
        _build.CSRC, _build.BUILD_DIR = saved[0], saved[1]
        _build._LIBS.pop("decode_attention", None)
        if saved[2] is not None:
            _build._LIBS["decode_attention"] = saved[2]
        for buf in da._COUNTERS.get(q.device, []):   # a cut left them counting
            buf.zero_()
    return rows


def conv_rows(log) -> List[dict]:
    """conv2d at 2048² for each band height."""
    g = torch.Generator(device="cuda").manual_seed(1)
    c = torch.randn(3, 3, generator=g, device="cuda")
    rows = []
    saved = dict(pb.CONV_BAND)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            As = [torch.randn(2048, 2048, generator=g, device="cuda")
                  .to(dtype) for _ in range(4)]
            cyc = itertools.cycle(As)
            for band in CONV_BANDS:
                pb.CONV_BAND[dtype] = band
                t = _times(lambda: pb.conv2d(next(cyc), c))
                rows.append({"kernel": "conv2d", "dtype": str(dtype)[6:],
                             "band": band, "ms": t})
                log(f"conv2d 2048x2048 {str(dtype)[6:]} bands of {band} "
                    f"rows: {_fmt(t)} ms")
    finally:
        pb.CONV_BAND.update(saved)
    return rows


def _fmt(t: List[float]) -> str:
    return " / ".join(f"{x:.4f}" for x in t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="BENCH_kernel_sweep_torch.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_sweep: CUDA is not available; this needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    card = ks.card_line()

    def log(msg: str) -> None:
        print(f"[kernel_sweep] {card}: {msg}", flush=True)

    rows: Dict[str, List[dict]] = {"decode": decode_rows(log),
                                   "conv2d": conv_rows(log)}
    Path(args.out).write_text(json.dumps({"card": card, **rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
