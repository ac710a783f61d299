"""AutoDMA — automatic tiling and transfer inference (HEROv2 §2.2.2, §3.2).

Counterpart of ``repro/core/autodma.py``. The planner is copied as it is:
from an access-pattern spec of a kernel (which array dimension each loop
axis indexes) and the L1 budget (``heromem.hero_l1_capacity()``, on the
card the shared memory of one block) it chooses per-axis tiles, the grid
and the block shapes, with the paper-style traffic and DMA-burst model.
Modes mirror the paper's Fig. 7 bars:

  * ``unmodified`` — no staging: whole-array blocks;
  * ``paper``      — the paper's §3.1 rule S = floor((L/N)^(1/D)),
                     single-buffered;
  * ``autodma``    — the traffic-minimising search, double-buffered;
  * ``handwritten``— expert tiles through the same Plan (kernels/gemm.py).

The granules are read from :mod:`heromem` at call time, so the planner
gives the JAX planner's plans when given the TPU's constants.

:func:`tiled_call` is the builder (the JAX ``autodma.pallas_call``): it
returns ``(call, plan)``; ``call(*tensors)`` launches the hand-written CUDA
builder (``kernels/tiled.py``) for CUDA tensors and runs the plain grid
walker :func:`walk` for CPU tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import heromem

FULL = "full"  # dimension resident in L1 (not tiled)


@dataclasses.dataclass(frozen=True)
class ArrayAccess:
    """Access pattern of one array inside the kernel's loop nest.

    ``dims`` maps each array dimension to either a grid-axis index (int) or
    ``FULL``. E.g. matmul C[i,j] += A[i,k]·B[k,j] over grid (i, j, k):
    A=(0, 2), B=(2, 1), C=(0, 1).
    """
    name: str
    shape: Tuple[int, ...]
    dims: Tuple[object, ...]  # int grid axis | FULL
    dtype: torch.dtype = torch.float32
    is_output: bool = False

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Abstract kernel: iteration space + array accesses (+ flops/point)."""
    name: str
    loop_bounds: Tuple[int, ...]          # iteration-space size per grid axis
    arrays: Tuple[ArrayAccess, ...]
    reduction_axes: Tuple[int, ...] = ()  # axes contracted away (innermost)
    flops_per_point: int = 2              # e.g. MAC = 2 flops

    def outputs(self) -> List[ArrayAccess]:
        return [a for a in self.arrays if a.is_output]

    def inputs(self) -> List[ArrayAccess]:
        return [a for a in self.arrays if not a.is_output]


@dataclasses.dataclass
class Plan:
    """Planner result: the tiling the builder needs, plus the paper-style
    DMA accounting used by the benchmarks."""
    spec: KernelSpec
    tiles: Tuple[int, ...]                # tile size per grid axis
    grid: Tuple[int, ...]                 # n_tiles per grid position (parallel..., reduction...)
    grid_axes: Tuple[int, ...]            # original axis id per grid position
    block_shapes: Dict[str, Tuple[int, ...]]
    index_maps: Dict[str, Callable]       # grid position -> block index per dim
    traffic_bytes: int                    # modeled device-memory traffic
    vmem_bytes: int                       # peak staged working set (incl. double-buffer)
    dma_bursts: int                       # number of contiguous transfers
    dma_reconfigs: int                    # burst-descriptor reprograms (2D transfers)
    mode: str = "autodma"

    @property
    def flops(self) -> int:
        return self.spec.flops_per_point * math.prod(self.spec.loop_bounds)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(1, self.traffic_bytes)

    @property
    def double_buffered(self) -> bool:
        """Whether the plan's L1 count holds two copies of every block."""
        return self.vmem_bytes == 2 * sum(
            math.prod(self.block_shapes[a.name]) * a.itemsize
            for a in self.spec.arrays)


# --------------------------------------------------------------------------
# tile-size search
# --------------------------------------------------------------------------
def _granule(access: ArrayAccess, dim: int) -> int:
    """Tiling granule for this array dimension (1 for untiled dims)."""
    nd = len(access.shape)
    if dim == nd - 1:
        return heromem.LANE
    if dim == nd - 2:
        return heromem.SUBLANE.get(access.itemsize, 8)
    return 1


def _axis_granule(spec: KernelSpec, axis: int) -> int:
    """A grid axis must satisfy the strictest granule of any dim it tiles."""
    g = 1
    for a in spec.arrays:
        for d, ax in enumerate(a.dims):
            if ax == axis:
                g = max(g, _granule(a, d))
    return g


def _candidates(bound: int, granule: int) -> List[int]:
    """Tile-size candidates: granule × {2^i, 3·2^i}, restricted to exact
    divisors of the bound; the full bound is always a candidate."""
    out = set()
    t = granule
    while t < bound:
        if bound % t == 0:
            out.add(t)
        t32 = 3 * t // 2
        if t32 % granule == 0 and t32 <= bound and bound % t32 == 0:
            out.add(t32)
        t *= 2
    out.add(bound)
    return sorted(out)


def _block_shape(access: ArrayAccess, tiles: Sequence[int]) -> Tuple[int, ...]:
    return tuple(access.shape[d] if ax == FULL else min(tiles[ax], access.shape[d])
                 for d, ax in enumerate(access.dims))


def _block_bytes(access: ArrayAccess, tiles: Sequence[int]) -> int:
    return math.prod(_block_shape(access, tiles)) * access.itemsize


def _n_tiles(spec: KernelSpec, tiles: Sequence[int]) -> List[int]:
    return [-(-b // t) for b, t in zip(spec.loop_bounds, tiles)]


def _traffic(spec: KernelSpec, tiles: Sequence[int]) -> int:
    """Σ size(A) · Π_{axes not indexing A} n_tiles — each array is refetched
    once per tile combination of the axes it does not depend on."""
    nt = _n_tiles(spec, tiles)
    total = 0
    for a in spec.arrays:
        touched = {ax for ax in a.dims if ax != FULL}
        refetch = math.prod(nt[g] for g in range(len(nt)) if g not in touched)
        size = math.prod(a.shape) * a.itemsize
        mult = 2 if a.is_output and spec.reduction_axes else 1  # rmw outputs
        total += size * refetch * mult
    return total


def streaming_traffic(spec: KernelSpec) -> int:
    """Traffic of the *unmodified* program (paper Fig. 4 baseline): every
    operand from main memory at every iteration point, no reuse."""
    points = math.prod(spec.loop_bounds)
    return sum(points * a.itemsize for a in spec.arrays)


def _bursts(spec: KernelSpec, tiles: Sequence[int], assume_contiguous: bool) -> Tuple[int, int]:
    """Paper-style DMA accounting: a block transfer of a tile whose last dim
    spans the full array row is ONE burst per remaining row-group; otherwise
    each partial row is its own burst. Row-merging across the second-to-last
    dim is only allowed when contiguity is provable (assume_contiguous)."""
    nt = _n_tiles(spec, tiles)
    grid_steps = math.prod(nt)
    bursts = 0
    reconfigs = 0
    for a in spec.arrays:
        touched = {ax for ax in a.dims if ax != FULL}
        visits = math.prod(nt[g] for g in range(len(nt)) if g not in touched) * \
            math.prod(nt[ax] for ax in touched)
        bs = _block_shape(a, tiles)
        last_full = bs[-1] == a.shape[-1]
        rows = math.prod(bs[:-1]) if len(bs) > 1 else 1
        if last_full and assume_contiguous:
            per_visit = 1                      # rows merge into one burst
        elif last_full:
            per_visit = rows // max(1, bs[-2] if len(bs) > 1 else 1)
            per_visit = max(1, per_visit)      # one burst per contiguous plane
        else:
            per_visit = rows                   # one burst per partial row
        bursts += visits * per_visit
        reconfigs += visits * (1 if per_visit == 1 else 1 + (per_visit > 1))
    return bursts, reconfigs + grid_steps


def _index_maps(spec: KernelSpec, pos_of_axis: Dict[int, int]) -> Dict[str, Callable]:
    maps = {}
    for a in spec.arrays:
        def imap(*pids, _dims=a.dims, _pos=pos_of_axis):
            return tuple(0 if ax == FULL else pids[_pos[ax]] for ax in _dims)
        maps[a.name] = imap
    return maps


def plan(spec: KernelSpec, budget: Optional[int] = None, double_buffer: bool = True,
         mode: str = "autodma", assume_contiguous: bool = False,
         max_search: int = 200_000) -> Plan:
    """Derive the grid and block shapes for ``spec`` under the L1 budget.

    mode="autodma": traffic-minimizing search.
    mode="paper":   the paper's equal-side heuristic S=floor((L/N)^(1/D)).
    mode="unmodified": no tiling — whole arrays as single blocks.
    """
    if budget is None:
        budget = heromem.hero_l1_capacity()
    # paper fidelity: HEROv2's heuristic tiling "does not exploit double
    # buffering" (§3.1) — its rule fills L1 exactly, single-buffered
    buf = 1 if mode == "paper" else (2 if double_buffer else 1)
    naxes = len(spec.loop_bounds)

    if mode == "unmodified":
        tiles = tuple(spec.loop_bounds)
    elif mode == "paper":
        n_arrays = len(spec.arrays)
        dims_per_array = max(sum(1 for ax in a.dims if ax != FULL) for a in spec.arrays)
        itemsize = max(a.itemsize for a in spec.arrays)
        side = heromem.paper_tile_side(n_arrays, max(1, dims_per_array),
                                       capacity_words=budget // itemsize)
        tiles_l = []
        for g in range(naxes):
            cand = _candidates(spec.loop_bounds[g], _axis_granule(spec, g))
            fits = [c for c in cand if c <= side]
            tiles_l.append(fits[-1] if fits else cand[0])
        tiles = tuple(tiles_l)
    else:
        tiles = _search(spec, budget, buf, max_search, heromem.LANE,
                        tuple(sorted(heromem.SUBLANE.items())))

    nt = _n_tiles(spec, tiles)
    # grid order: parallel axes first, reduction axes innermost (last) so the
    # output block stays resident across the contraction
    par = [g for g in range(naxes) if g not in spec.reduction_axes]
    red = list(spec.reduction_axes)
    order = par + red
    grid = tuple(nt[g] for g in order)
    pos_of_axis = {ax: i for i, ax in enumerate(order)}
    block_shapes = {a.name: _block_shape(a, tiles) for a in spec.arrays}

    vmem = sum(_block_bytes(a, tiles) for a in spec.arrays) * buf
    bursts, reconf = _bursts(spec, tiles, assume_contiguous)
    traffic = streaming_traffic(spec) if mode == "unmodified" else _traffic(spec, tiles)
    return Plan(spec=spec, tiles=tiles, grid=grid, grid_axes=tuple(order),
                block_shapes=block_shapes,
                index_maps=_index_maps(spec, pos_of_axis),
                traffic_bytes=traffic, vmem_bytes=vmem,
                dma_bursts=bursts, dma_reconfigs=reconf, mode=mode)


@functools.lru_cache(maxsize=1024)
def _search(spec: KernelSpec, budget: int, buf: int, max_search: int,
            lane: int, sublane: Tuple[Tuple[int, int], ...]) -> Tuple[int, ...]:
    """Exhaustive-over-candidates search (candidate lists are log-sized).

    Memoised, as a compiler plans once per kernel: the key holds the
    granules (``lane``, ``sublane``) the candidates are read from, so a
    changed ``heromem`` granule plans afresh. It returns a tuple."""
    naxes = len(spec.loop_bounds)
    cand = [_candidates(spec.loop_bounds[g], _axis_granule(spec, g))
            for g in range(naxes)]
    best, best_key = None, None
    n = 0
    for combo in itertools.product(*cand):
        n += 1
        if n > max_search:
            break
        vmem = sum(_block_bytes(a, combo) for a in spec.arrays) * buf
        if vmem > budget:
            continue
        t = _traffic(spec, combo)
        # tie-break: fewer grid steps (less pipeline overhead), larger last tile
        key = (t, math.prod(_n_tiles(spec, combo)), -combo[-1])
        if best_key is None or key < best_key:
            best, best_key = combo, key
    if best is None:
        # nothing fits (arrays with FULL dims too big) — degrade to granules
        best = tuple(_axis_granule(spec, g) for g in range(naxes))
    return tuple(best)


# --------------------------------------------------------------------------
# the builder: a plan around a body
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Body:
    """A kernel body for :func:`tiled_call`.

    ``cuda`` names the device body in ``csrc/autodma_tiled.cu`` (see
    ``kernels/tiled.py``: ``gemm_mxu``, ``gemm_vpu``, ``gemm_loop``,
    ``gram``, ``matvec``, ``matvec_t``, ``center``); ``plain`` is the same
    body in PyTorch, ``plain(*in_blocks, *out_blocks, axis_info)``, writing
    its output blocks in place as a Pallas body writes its refs; ``alpha``
    scales each reduction step's product (gemm, gram).
    """
    cuda: str
    plain: Callable
    alpha: float = 1.0


def _block(t: torch.Tensor, access: ArrayAccess, plan_: Plan,
           pids: Sequence[int]) -> torch.Tensor:
    """The view of ``t`` the grid position ``pids`` gives ``access`` (the
    last block along an axis the tile does not divide is cut short)."""
    bs = plan_.block_shapes[access.name]
    idx = plan_.index_maps[access.name](*pids)
    return t[tuple(slice(b * s, b * s + s) for b, s in zip(idx, bs))]


def walk(body: Callable, plan_: Plan, *tensors: torch.Tensor):
    """The plain grid walker: the Pallas semantics written out in PyTorch.

    Loops over ``plan_.grid`` in order (parallel axes, then reduction
    axes), cuts each array's block from its ``dims`` and block shape, and
    calls ``body(*in_blocks, *out_blocks, axis_info=...)`` with
    ``axis_info[axis] = (program id, number of programs)``.
    """
    spec = plan_.spec
    ins, outs = spec.inputs(), spec.outputs()
    if len(tensors) != len(ins):
        raise ValueError(f"{spec.name}: {len(ins)} inputs, got {len(tensors)}")
    dev = tensors[0].device
    results = [torch.empty(o.shape, dtype=o.dtype, device=dev) for o in outs]
    for pids in itertools.product(*(range(n) for n in plan_.grid)):
        axis_info = {ax: (pids[i], plan_.grid[i])
                     for i, ax in enumerate(plan_.grid_axes)}
        blocks = [_block(t, a, plan_, pids) for t, a in zip(tensors, ins)]
        blocks += [_block(r, a, plan_, pids) for r, a in zip(results, outs)]
        body(*blocks, axis_info=axis_info)
    return results[0] if len(results) == 1 else tuple(results)


def tiled_call(body: Body, spec: KernelSpec, plan_: Optional[Plan] = None,
               **plan_kwargs):
    """``autodma.tiled_call(body, spec)`` — the zero-code-change entry point;
    counterpart of the JAX ``autodma.pallas_call`` (core/autodma.py:321).

    Returns ``(call, plan)``. ``call(*inputs)`` takes the spec's inputs in
    order: CUDA tensors launch the hand-written builder kernel
    (``kernels/tiled.py``, ``csrc/autodma_tiled.cu``) or raise; CPU (and
    ``meta``) tensors take :func:`walk` with ``body.plain``.
    """
    p = plan_ or plan(spec, **plan_kwargs)

    def call(*tensors: torch.Tensor):
        dev = tensors[0].device
        if dev.type in ("cpu", "meta"):     # meta: shapes alone
            return walk(body.plain, p, *tensors)
        if dev.type != "cuda":
            raise ValueError(f"{spec.name}: unsupported device {dev}")
        from repro_torch.kernels import tiled
        return tiled.launch(body, p, *tensors)

    return call, p


# --------------------------------------------------------------------------
# spec builders for the common patterns (what HePREM extracts from IR)
# --------------------------------------------------------------------------
def matmul_spec(M: int, N: int, K: int, dtype=torch.float32, name="gemm",
                flops_per_point: int = 2) -> KernelSpec:
    return KernelSpec(
        name=name, loop_bounds=(M, N, K), reduction_axes=(2,),
        flops_per_point=flops_per_point,
        arrays=(
            ArrayAccess("A", (M, K), (0, 2), dtype),
            ArrayAccess("B", (K, N), (2, 1), dtype),
            ArrayAccess("C", (M, N), (0, 1), dtype, is_output=True),
        ))


def elementwise_spec(shape: Tuple[int, ...], n_in: int = 1, dtype=torch.float32,
                     name="eltwise", flops_per_point: int = 1) -> KernelSpec:
    axes = tuple(range(len(shape)))
    arrs = [ArrayAccess(f"x{i}", shape, axes, dtype) for i in range(n_in)]
    arrs.append(ArrayAccess("y", shape, axes, dtype, is_output=True))
    return KernelSpec(name=name, loop_bounds=shape, arrays=tuple(arrs),
                      flops_per_point=flops_per_point)


def matvec_spec(M: int, N: int, dtype=torch.float32, name="matvec") -> KernelSpec:
    # y[i] = sum_j A[i,j] x[j]
    return KernelSpec(
        name=name, loop_bounds=(M, N), reduction_axes=(1,), flops_per_point=2,
        arrays=(
            ArrayAccess("A", (M, N), (0, 1), dtype),
            ArrayAccess("x", (N,), (1,), dtype),
            ArrayAccess("y", (M,), (0,), dtype, is_output=True),
        ))


def conv2d_3x3_spec(H: int, W: int, dtype=torch.float32, name="conv2d") -> KernelSpec:
    """Paper Table 2 conv2d: 3×3 stencil, columns tiled, rows resident."""
    return KernelSpec(
        name=name, loop_bounds=(H, W), reduction_axes=(), flops_per_point=18,
        arrays=(
            ArrayAccess("A", (H, W), (0, 1), dtype),
            ArrayAccess("B", (H, W), (0, 1), dtype, is_output=True),
        ))
