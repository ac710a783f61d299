"""The AutoDMA builder on the card: a Plan launched as ``csrc/autodma_tiled.cu``.

Counterpart of the Pallas builder ``repro/core/autodma.py:pallas_call``.
:func:`launch` turns a :class:`~repro_torch.core.autodma.Plan` and a body
into one launch of the hand-written kernel: it lays the plan out as the
kernel's int fields (:func:`layout`: grid, tiles, per-array axis maps,
shared-memory offsets of the staged blocks, threads), checks the tensors,
and raises on anything the kernel does not take, such as a plan whose
staged blocks exceed the 232,448 bytes of shared memory a block may use.
There is no fallback.

The bodies come in three families: gemm (``gemm_mxu``, ``gemm_vpu``,
``gemm_loop``, and ``gram``, whose A is read through (reduction, row) as
covar's DcᵀDc reads Dc), matvec (``matvec``, ``matvec_t``), and the
elementwise family for specs without a reduction axis (``center``: y =
x0 − x1), which runs as one reduction step over a virtual axis of bound 1.

gemm and ``center`` run one block per plan tile. The matvec family is
bound by bytes (A is read once: 0.0050 ms at 2048² f32 on the H100), and
its plans have few tiles (32 for autodma at 2048² f32), so a tile's
reduction steps are spread over the ``ks`` blocks of one thread-block
cluster (field ``ks``, at most 8; ``blocks`` stays the plan's tile count):
each block runs ⌈nk / ks⌉ steps in order, block 0 folds every step's f32
partial in step order with the reference's rounding after each. The
unmodified plans' own grid splits matvec_t's rows over a cluster too.

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
          "matvec_t": 4, "center": 5, "gram": 6}
GEMM_BODIES = ("gemm_mxu", "gemm_vpu", "gemm_loop")
ELTWISE_BODIES = ("center",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's int fields, in the order of enum Field in the source
FIELDS = ("body", "dtype", "staged", "nbuf", "stage_bytes", "out_off",
          "smem", "threads", "blocks", "ks", "fpw", "npass", "nrg", "ncg",
          "bound0", "bound1", "bound2", "tile0", "tile1", "tile2",
          "ntile0", "ntile1", "ntile2", "par0", "par1", "red",
          "out_rows", "out_cols", "out_ax0", "out_ax1") + tuple(
              f"in{k}_{f}" for k in range(2)
              for f in ("rows", "cols", "ax0", "ax1", "ld", "prow", "pcol",
                        "soff"))
MAX_THREADS = 512
FRAG_ROWS, FRAG_COLS = 16, 32   # one gemm fragment (mma layout)
# a warp's gemm sub-tile is WR fragments down one column of them (field
# fpw), WR in FPW; a gemm block holds at most 8 warps (the kernel's launch
# bound of 256 threads lets a thread keep 255 registers: the step's
# product and the output tile, 2 x 16 WR accumulators, and the fragments
# of several k-steps in flight)
FPW = (4, 2, 1)
MAX_GEMM_WARPS = 8
# the fewest warps a block should have to work with (below it, the next
# smaller sub-tile is taken); warps past the sub-tiles only stage. On the
# H100, 8 ran faster than 4 at gemm 2048³ and darknet in every mode but
# paper, whose tile takes 8 warps either way
MIN_WARPS = 8
MATVEC_THREADS = 256
ELTWISE_THREADS = 256
# the matvec family spreads a plan tile's reduction steps over the blocks of
# one thread-block cluster, at most the portable 8 (field ks); each lane
# keeps LOADS 16-byte loads in flight (MatvecBody::kLoads in the source)
MAX_CLUSTER = 8
LOADS = 8
# unmodified plans run unstaged on the kernel's own grid of output tiles:
# 64x64 gemm and elementwise tiles, a row per warp (matvec), 128 bytes of
# columns a block (matvec_t: 32 f32, 64 bf16)
UNSTAGED_TILE = {"gemm_mxu": 64, "gemm_vpu": 64, "gemm_loop": 64,
                 "gram": 64, "center": 64, "matvec": MATVEC_THREADS // 32}
UNSTAGED_ROW_BYTES = 128
# matvec_t's own grid also splits A's rows (its reduction) over a cluster,
# in chunks of at least one load of every lane's LOADS (row groups of the
# block, threads over the 16-byte vectors of a row, x LOADS rows), and to
# about SPLIT_BLOCKS blocks in all: about two an SM, all resident at once
UNSTAGED_SPLIT_ROWS = MATVEC_THREADS // (UNSTAGED_ROW_BYTES // 16) * LOADS
SPLIT_BLOCKS = 256
# row-pitch skew, in 4-byte words, that keeps the gemm fragment loads from
# shared memory free of bank conflicts: an array read along its rows (the
# reduction axis on its columns, gemm's A: ldmatrix) takes the first; one
# read down its columns (the reduction axis on its rows: B, and gram's A)
# the second, by dtype: f32 is read a 32-bit element a lane at (k = q,
# n = g), 8 words apart row to row; bf16 by ldmatrix.trans, 16-byte rows
SKEW_WORDS = {torch.float32: (4, 8), torch.bfloat16: (4, 4)}


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


def red_floats(ext: int, item: int) -> int:
    """f32 slots of matvec_t's row-group sums for an output tile of ``ext``
    columns (as ``MatvecBody::step`` lays them out): 16-byte vectors of
    columns across the threads, ``nvb`` of them a pass; the sums of a warp's
    row groups are added by shuffles first where ``nvb`` divides 32."""
    v = 16 // item
    nvb = min(-(-ext // v), MATVEC_THREADS)
    in_warp = nvb < 32 and 32 % nvb == 0
    groups = MATVEC_THREADS // 32 if in_warp else MATVEC_THREADS // nvb
    return groups * nvb * v


def _family(body_name: str) -> str:
    if body_name in GEMM_BODIES + ("gram",):
        return "gemm"
    return "eltwise" if body_name in ELTWISE_BODIES else "matvec"


def warp_layout(nrg: int, ncg: int) -> tuple:
    """(fpw, warps, npass) for an output tile of ``nrg`` x ``ncg`` gemm
    fragments: the sub-tile of ``fpw`` fragments (a column of them) that
    covers the tile in the fewest passes with at least :data:`MIN_WARPS`
    sub-tiles, the largest such. Sub-tile ``w`` of pass ``p`` belongs to warp
    ``w - p * warps``; the sub-tiles are row-major over the tile."""
    def cost(wr):
        tiles = -(-nrg // wr) * ncg
        warps = min(max(tiles, MIN_WARPS), MAX_GEMM_WARPS)
        return (-(-tiles // warps), tiles < MIN_WARPS, -wr), warps
    wr = min(FPW, key=lambda w: cost(w)[0])
    (npass, _, _), warps = cost(wr)
    return wr, warps, npass


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
    family = _family(body_name)
    ins, outs = spec.inputs(), spec.outputs()
    naxes = len(spec.loop_bounds)
    nred = 0 if family == "eltwise" else 1
    if len(ins) != 2 or len(outs) != 1 or naxes + 1 - nred > 3 or \
            len(spec.reduction_axes) != nred:
        raise ValueError(f"tiled: body {body_name} needs 2 inputs, 1 output, "
                         f"at most {2 + nred} loop axes and {nred} reduction "
                         f"axis; {spec.name} has {len(ins)}, {len(outs)}, "
                         f"{naxes} and {len(spec.reduction_axes)}")
    dtype = ins[0].dtype
    if dtype not in DTYPES or any(a.dtype != dtype for a in spec.arrays):
        raise TypeError(f"tiled: {spec.name} arrays must share one dtype in "
                        f"{tuple(DTYPES)}")
    rank = [len(a.shape) for a in spec.arrays]
    if rank != ([2, 1, 1] if family == "matvec" else [2, 2, 2]):
        raise ValueError(f"tiled: body {body_name} does not fit {spec.name} "
                         f"(array ranks {rank})")
    if nred:
        par = list(grid_axes[:naxes - 1])
        red = grid_axes[naxes - 1]
    else:   # one reduction step over a virtual axis of bound 1
        par, red = list(grid_axes), naxes
    bound = list(spec.loop_bounds) + [1] * (3 - naxes)
    staged = mode != "unmodified"
    tile = list(tiles) + [1] * (3 - naxes)
    item = dtype.itemsize
    if not staged:                       # the kernel's own grid, one k-step
        for ax in par:
            tile[ax] = min(bound[ax], UNSTAGED_ROW_BYTES // item
                           if body_name == "matvec_t"
                           else UNSTAGED_TILE[body_name])
        if body_name == "matvec_t":      # its rows in chunks over a cluster
            tiles_out = -(-bound[par[0]] // tile[par[0]])
            chunks = max(1, min(MAX_CLUSTER, SPLIT_BLOCKS // tiles_out,
                                -(-bound[red] // UNSTAGED_SPLIT_ROWS)))
            tile[red] = -(-bound[red] // chunks)
    ntile = [-(-b // t) for b, t in zip(bound, tile)]
    # a plan tile's steps over a cluster of ks blocks, per = ceil(nk / ks)
    # each in step order (every block runs at least one)
    per = -(-ntile[red] // MAX_CLUSTER) if family == "matvec" else ntile[red]
    ks = -(-ntile[red] // per)
    f = dict(body=BODIES[body_name], dtype=DTYPES[dtype], staged=int(staged),
             nbuf=2 if double_buffered else 1, bound0=bound[0],
             bound1=bound[1], bound2=bound[2], tile0=tile[0], tile1=tile[1],
             tile2=tile[2], ntile0=ntile[0], ntile1=ntile[1],
             ntile2=ntile[2], par0=par[0],
             par1=par[1] if len(par) > 1 else -1, red=red,
             blocks=math.prod(ntile[a] for a in par), ks=ks)
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
            ld = pcol + SKEW_WORDS[dtype][ax0 == red] * 4 // item
        else:   # the other bodies stop at the extents; rows of 16 bytes
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
    b_map = (f["in1_ax0"], f["in1_ax1"])
    fits = {"gemm": a_map == (out_ax0, red) and b_map == (red, out_ax1),
            "gram": a_map == (red, out_ax0) and b_map == (red, out_ax1),
            "matvec": a_map == (out_ax1, red) and f["in1_ax1"] == red,
            "matvec_t": a_map == (red, out_ax1) and f["in1_ax1"] == red,
            "center": a_map == b_map == (out_ax0, out_ax1)}
    if not fits["gemm" if body_name in GEMM_BODIES else body_name]:
        raise ValueError(f"tiled: body {body_name} does not fit the axis "
                         f"maps of {spec.name}")
    f.update(out_rows=out_rows, out_cols=out_cols, out_ax0=out_ax0,
             out_ax1=out_ax1)
    f["out_off"] = f["nbuf"] * f["stage_bytes"]
    if family == "matvec":   # the stage buffers a block uses
        f["out_off"] = min(f["nbuf"], per) * f["stage_bytes"]
    if family == "gemm":
        nrg = -(-min(tile[out_ax0], out_rows) // FRAG_ROWS)
        ncg = -(-min(tile[out_ax1], out_cols) // FRAG_COLS)
        fpw, warps, npass = warp_layout(nrg, ncg)
        f.update(nrg=nrg, ncg=ncg, fpw=fpw, threads=32 * warps,
                 npass=npass)
        out_bytes = 0
    elif family == "eltwise":   # stores straight from the staged blocks
        f.update(nrg=0, ncg=0, fpw=0, npass=1, threads=ELTWISE_THREADS)
        out_bytes = 0
    else:
        f.update(nrg=0, ncg=0, fpw=0, npass=1, threads=MATVEC_THREADS)
        # the f32 partial of every step of the tile (block 0's are folded),
        # and matvec_t's row-group sums of one step, for a whole tile or the
        # ragged last one
        ext = min(tile[out_ax1], out_cols)
        last = out_cols - (ntile[out_ax1] - 1) * tile[out_ax1]
        out_bytes = ntile[red] * _round_up(tile[out_ax1], 4) * 4 + (
            4 * max(red_floats(ext, item), red_floats(last, item))
            if body_name == "matvec_t" else 0)
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
