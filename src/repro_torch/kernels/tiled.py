"""The AutoDMA builder on the card: a Plan launched as ``csrc/autodma_tiled.cu``.

Counterpart of the Pallas builder ``repro/core/autodma.py:pallas_call``.
:func:`launch` turns a :class:`~repro_torch.core.autodma.Plan` and a body
into one launch of the hand-written kernel: it lays the plan out as the
kernel's int fields (:func:`layout`: grid, tiles, per-array axis maps,
shared-memory offsets of the staged blocks, threads), checks the tensors,
and raises on anything the kernel does not take, such as a plan whose
staged blocks exceed the 232,448 bytes of shared memory a block may use.
There is no fallback.

``launch.launches`` counts the builder's launches. The plain version is the
grid walker :func:`repro_torch.core.autodma.walk`, which
:func:`~repro_torch.core.autodma.tiled_call` takes for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Sequence

import torch

from repro_torch.core import autodma
from repro_torch.core.heromem import SMEM_PER_BLOCK
from repro_torch.kernels import _build

# the device bodies of csrc/autodma_tiled.cu (enum BodyId)
BODIES = {"gemm_mxu": 0, "gemm_vpu": 1, "gemm_loop": 2, "matvec": 3,
          "matvec_t": 4}
GEMM_BODIES = ("gemm_mxu", "gemm_vpu", "gemm_loop")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's int fields, in the order of enum Field in the source
FIELDS = ("body", "dtype", "staged", "nbuf", "stage_bytes", "out_off",
          "smem", "threads", "blocks", "fpw", "npass", "nrg", "ncg",
          "bound0", "bound1", "bound2", "tile0", "tile1", "tile2",
          "ntile0", "ntile1", "ntile2", "par0", "par1", "red",
          "out_rows", "out_cols", "out_ax0", "out_ax1") + tuple(
              f"in{k}_{f}" for k in range(2)
              for f in ("rows", "cols", "ax0", "ax1", "ld", "prow", "pcol",
                        "soff"))
MAX_THREADS = 512
MAX_WARPS = MAX_THREADS // 32
FRAG_ROWS, FRAG_COLS = 16, 32   # one warp's gemm fragment (mma layout)
# fragments a warp holds in registers; a larger output tile takes passes
FPW = (1, 2, 4)
MATVEC_THREADS = 256
# unmodified plans run unstaged on the kernel's own grid of output tiles:
# 64x64 gemm tiles, a row per warp (matvec), 32 columns a block (matvec_t)
UNSTAGED_TILE = {"gemm_mxu": 64, "gemm_vpu": 64, "gemm_loop": 64,
                 "matvec": MATVEC_THREADS // 32, "matvec_t": 32}
# row-pitch skew, in 4-byte words, that keeps the gemm fragment loads from
# shared memory free of bank conflicts (A read along rows, B down columns)
SKEW_WORDS = (4, 8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _as_2d(a: autodma.ArrayAccess):
    """(rows, cols, ax0, ax1) of an array seen as 2-D; -1 = FULL."""
    ax = [-1 if d == autodma.FULL else int(d) for d in a.dims]
    if len(a.shape) == 1:
        return 1, a.shape[0], -1, ax[0]
    if len(a.shape) == 2:
        return a.shape[0], a.shape[1], ax[0], ax[1]
    raise ValueError(f"tiled: {a.name} has rank {len(a.shape)}; the builder "
                     "takes 1-D and 2-D arrays")


def _family(body_name: str) -> str:
    return "gemm" if body_name in GEMM_BODIES else "matvec"


def _plan_key(plan_: autodma.Plan) -> tuple:
    return (plan_.spec, tuple(plan_.tiles), tuple(plan_.grid_axes),
            plan_.mode, plan_.double_buffered)


def layout(body_name: str, plan_: autodma.Plan) -> Dict[str, int]:
    """The kernel's int fields for ``plan_`` run with ``body_name``.

    Raises ValueError for a spec or plan the builder does not take.
    """
    return dict(zip(FIELDS, _fields(body_name, *_plan_key(plan_))))


@functools.lru_cache(maxsize=1024)
def _fields(body_name: str, spec: autodma.KernelSpec, tiles: tuple,
            grid_axes: tuple, mode: str, double_buffered: bool) -> tuple:
    """:func:`layout` as a tuple in FIELDS order, memoised per plan."""
    if body_name not in BODIES:
        raise ValueError(f"tiled: unknown body {body_name!r}")
    ins, outs = spec.inputs(), spec.outputs()
    naxes = len(spec.loop_bounds)
    if len(ins) != 2 or len(outs) != 1 or naxes > 3 or \
            len(spec.reduction_axes) != 1:
        raise ValueError(f"tiled: {spec.name} needs 2 inputs, 1 output, at "
                         "most 3 loop axes and one reduction axis")
    dtype = ins[0].dtype
    if dtype not in DTYPES or any(a.dtype != dtype for a in spec.arrays):
        raise TypeError(f"tiled: {spec.name} arrays must share one dtype in "
                        f"{tuple(DTYPES)}")
    family = _family(body_name)
    rank = [len(a.shape) for a in spec.arrays]
    if rank != ([2, 2, 2] if family == "gemm" else [2, 1, 1]):
        raise ValueError(f"tiled: body {body_name} does not fit {spec.name} "
                         f"(array ranks {rank})")
    npar = naxes - 1
    par = list(grid_axes[:npar])
    red = grid_axes[npar]
    bound = list(spec.loop_bounds) + [1] * (3 - naxes)
    staged = mode != "unmodified"
    tile = list(tiles) + [1] * (3 - naxes)
    if not staged:                       # the kernel's own grid, one k-step
        for ax in par:
            tile[ax] = min(bound[ax], UNSTAGED_TILE[body_name])
    ntile = [-(-b // t) for b, t in zip(bound, tile)]
    item = dtype.itemsize
    f = dict(body=BODIES[body_name], dtype=DTYPES[dtype], staged=int(staged),
             nbuf=2 if double_buffered else 1, bound0=bound[0],
             bound1=bound[1], bound2=bound[2], tile0=tile[0], tile1=tile[1],
             tile2=tile[2], ntile0=ntile[0], ntile1=ntile[1],
             ntile2=ntile[2], par0=par[0],
             par1=par[1] if npar > 1 else -1, red=red,
             blocks=math.prod(ntile[a] for a in par))
    soff = 0
    for k, a in enumerate(ins):
        rows, cols, ax0, ax1 = _as_2d(a)
        for n, ax in ((rows, ax0), (cols, ax1)):
            if ax >= 0 and n != bound[ax]:
                raise ValueError(f"tiled: {a.name} dim of {n} indexed by "
                                 f"axis {ax} of bound {bound[ax]}")
        e0 = rows if ax0 < 0 else min(tile[ax0], rows)
        e1 = cols if ax1 < 0 else min(tile[ax1], cols)
        if family == "gemm":   # zero padding to whole fragments, plus skew
            prow = _round_up(e0, FRAG_ROWS)
            pcol = _round_up(e1, FRAG_COLS)
            ld = pcol + SKEW_WORDS[k] * 4 // item
        else:   # the matvec bodies stop at the extents; rows of 16 bytes
            prow, pcol = e0, _round_up(e1, 8)
            ld = pcol
        f.update({f"in{k}_rows": rows, f"in{k}_cols": cols,
                  f"in{k}_ax0": ax0, f"in{k}_ax1": ax1, f"in{k}_ld": ld,
                  f"in{k}_prow": prow, f"in{k}_pcol": pcol,
                  f"in{k}_soff": soff})
        soff = _round_up(soff + prow * ld * item, 16)
    f["stage_bytes"] = soff if staged else 0
    out_rows, out_cols, out_ax0, out_ax1 = _as_2d(outs[0])
    # the axis maps each body is written against (its arrays' own layouts)
    a_map = (f["in0_ax0"], f["in0_ax1"])
    fits = {"gemm": a_map == (out_ax0, red) and
            (f["in1_ax0"], f["in1_ax1"]) == (red, out_ax1),
            "matvec": a_map == (out_ax1, red) and f["in1_ax1"] == red,
            "matvec_t": a_map == (red, out_ax1) and f["in1_ax1"] == red}
    if not fits["gemm" if family == "gemm" else body_name]:
        raise ValueError(f"tiled: body {body_name} does not fit the axis "
                         f"maps of {spec.name}")
    f.update(out_rows=out_rows, out_cols=out_cols, out_ax0=out_ax0,
             out_ax1=out_ax1)
    f["out_off"] = f["nbuf"] * f["stage_bytes"]
    if family == "gemm":
        nrg = -(-min(tile[out_ax0], out_rows) // FRAG_ROWS)
        ncg = -(-min(tile[out_ax1], out_cols) // FRAG_COLS)
        nfrag = nrg * ncg
        fpw = next((n for n in FPW if -(-nfrag // n) <= MAX_WARPS), FPW[-1])
        warps = max(4, min(MAX_WARPS, -(-nfrag // fpw)))
        f.update(nrg=nrg, ncg=ncg, fpw=fpw, threads=32 * warps,
                 npass=-(-nfrag // (warps * fpw)))
        out_bytes = 0
    else:
        f.update(nrg=0, ncg=0, fpw=0, npass=1, threads=MATVEC_THREADS)
        # the resident y tile (f32), and matvec_t's per-warp partial sums
        out_bytes = _round_up(tile[out_ax1], 32) * 4 + (
            MATVEC_THREADS * 4 if body_name == "matvec_t" else 0)
    f["smem"] = f["out_off"] + out_bytes
    if f["smem"] > SMEM_PER_BLOCK:
        raise ValueError(
            f"tiled: plan {mode} {tiles} of {spec.name} stages "
            f"{f['smem']} bytes; a block may use {SMEM_PER_BLOCK}")
    return tuple(f[k] for k in FIELDS)


def _check(spec: autodma.KernelSpec, tensors: Sequence[torch.Tensor]) -> None:
    ins = spec.inputs()
    if len(tensors) != len(ins):
        raise ValueError(f"tiled: {spec.name} takes {len(ins)} inputs")
    dev = tensors[0].device
    for t, a in zip(tensors, ins):
        if t.device != dev:
            raise ValueError(f"tiled: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"tiled: {a.name} must be contiguous")
        if t.dtype != a.dtype or tuple(t.shape) != tuple(a.shape):
            raise ValueError(f"tiled: {a.name} is {t.dtype} "
                             f"{tuple(t.shape)}, the spec says {a.dtype} "
                             f"{tuple(a.shape)}")


def launch(body: autodma.Body, plan_: autodma.Plan,
           *tensors: torch.Tensor) -> torch.Tensor:
    """Run ``plan_`` with ``body`` on CUDA tensors: one kernel launch."""
    spec = plan_.spec
    if tensors[0].device.type != "cuda":
        raise ValueError("tiled.launch takes CUDA tensors")
    _check(spec, tensors)
    f = _fields(body.cuda, *_plan_key(plan_))
    o = spec.outputs()[0]
    out = torch.empty(o.shape, dtype=o.dtype, device=tensors[0].device)
    fields = (ctypes.c_int * len(FIELDS))(*f)
    lib = _build.load("autodma_tiled")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.autodma_tiled(
        ctypes.c_void_p(tensors[0].data_ptr()),
        ctypes.c_void_p(tensors[1].data_ptr()),
        ctypes.c_void_p(out.data_ptr()), fields, len(FIELDS),
        ctypes.c_float(body.alpha), ctypes.c_void_p(stream))
    _build.check("autodma_tiled", err)
    launch.launches += 1
    return out


launch.launches = 0
