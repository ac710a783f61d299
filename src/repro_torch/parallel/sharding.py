"""Logical-axis sharding rules, a mesh of ranks, and the collectives over it.

Counterpart of ``repro/parallel/sharding.py``. The reference is one
controller over a mesh of devices; the port is one process a rank
(parallel/launch.py starts them), and this module holds both halves:

**The rules.** Model code names each leaf's axes logically (``("layers",
"embed_fsdp", "mlp_tp")``: models/transformer.py ``param_axes``);
:func:`resolve` binds them to mesh axes under :data:`DEFAULT_RULES` (or the
overrides of :func:`use_mesh`), exactly as the reference does: mesh axes
absent from the mesh are filtered out, a binding whose size does not divide
the dimension falls back to its first dividing axis or is dropped, and no
mesh axis serves two dimensions of one array. A spec is a plain tuple
whose entries are None, an axis name or a tuple of names; axes and spec
trees take :func:`is_spec` as core/tree.py's ``is_leaf``.

**The mesh.** A :class:`Mesh` maps axis names to sizes in the reference's
order (``pod``, ``data``, ``model``; or ``stage``) with the ranks laid out
row-major over them, as ``jax.make_mesh`` lays out its devices. Built over
the ranks of the running process group it holds one process group a line
of every set of its axes (:meth:`Mesh.line`), so a collective "over
``model``" runs over this rank's model line only; :meth:`Mesh.abstract`
gives the shape alone (``launch/mesh.py``'s production meshes).
:func:`shard_slices` / :func:`shard_of` give the slice of a leaf a rank
holds under a spec (``NamedSharding.devices_indices_map``'s counterpart);
:func:`held` the range of one dimension a rank's shard holds and the line
that cuts it (the whole dimension with no spec or no mesh), which the
serving steps read for every op (models/transformer.py ``hidden``), and
:func:`unbind` a spec once :func:`gather_leaf` has gathered some of its
axes.
:func:`constrain` returns its input: every rank already holds its own
activation, so the reference's ``with_sharding_constraint`` has nothing to
move.

**The collectives**, each over a :class:`Line` and each with its
gradient. Autograd across ranks follows one rule set. Each rank runs the
backward of its own loss; over the batch axes (``pod``, ``data``) the
step's gradient is the mean of the ranks' (train/step.py reduces it so);
over any other axis the ranks of one line hold one loss between them, and
the sum over the line of their gradient shares is the line's gradient
(Megatron's conjugate pairs: :func:`copy_to` / :func:`reduce_from`,
:func:`split_to` / :func:`gather_from`). :func:`gather_shards` is FSDP's
gather (each rank uses the whole leaf on its own rows, so its backward
reduce-scatters the sum), :func:`all_to_all` and :func:`ring_shift` move
rows and route the cotangents back the way they came, and :func:`pmean`
is the reference's ``_pmean_grad_safe``. :func:`combine_partials` (no
gradient: serving) merges the softmax attention of key slices the ranks
hold apart, from each slice's output and log-sum-exp: the reference's SP
decode, whose max / sum GSPMD turns into all-reduces; :func:`max_over`
(no gradient) is the vocabulary-parallel loss's max.

Which collective each position of a tensor-parallel layer takes under
autograd (models/attention.py ``gqa_forward``, models/transformer.py
``_ffn`` and the head, train/loss.py):

  * **entry** into work that differs by rank of a line (column-parallel
    projections, a rank's heads): ``copy_to``, so the input's gradient is
    the sum of the ranks' shares;
  * **row-parallel exit**: ``reduce_from`` (its backward passes the
    cotangent through: every rank then uses the sum alike); a sum each
    rank then uses on its own part (a norm's variance over a row cut by
    channels, partial products read by heads) takes ``reduce_from(...,
    apart=True)``, whose backward sums the cotangents as well;
  * **an activation gathered over the line and then used apart** (a
    rank's heads out of projection columns cut off a head's boundary):
    ``take(..., apart=True)``, whose gather is ``gather_shards``: the
    cotangent of each rank's part is the line's sum. ``gather_from``'s
    backward (the rank's slice of its own cotangent) is right only where
    every rank uses the gathered tensor alike (a leaf gathered whole
    before work that sums its ranks' shares itself: the MoE's experts,
    ``gather_leaf(..., alike=True)``);
  * **a leaf whole on the line that a rank narrows to its part**:
    ``copy_to`` on the leaf, so its gradient is summed over the line;
  * **the vocabulary**: no gather in training; the loss takes the
    rank's logits, its max over the line (``max_over``) and its sums
    (``reduce_from``). Serving still gathers the logits whole.

A leaf every rank of a line uses whole and alike (a norm, a bias added
after the row sum, the router) gets the same whole gradient on each rank
and is not summed over that line (train/step.py ``_reduce_grads`` sums
over the free batch axes alone).

*Transport.* The all-gather, the reduce-scatter and the all-to-all are
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` on every backend: gloo takes them for CPU tensors
and for CUDA tensors, which it stages through the host (a probe on the
card: parallel/mesh_jobs.py ``probe_job``). The ring shift is an
all-gather and a pick, also on every backend: gloo's send / recv of a CUDA
tensor raises or aborts the process (the same probe), so the ring keeps
one form that gloo takes on the CPU and on the card. On one card gloo's
times are transport for correctness, never speed; over NCCL these are
unmeasured until a multi-card call.

Every sum runs in f32 (a bf16 or f16 operand is widened first and the
result rounded once).

*On an abstract mesh* (:func:`record_collectives`, a dry run's traced
pass of one rank: rank 0), :meth:`Mesh.line` gives lines with no process
group, and each wire function records what it would issue
(``core/perf.Collective``: its kind, its result's bytes on the wire, its
group's size) and returns a tensor of the result's shape whose values
mean nothing (on ``meta`` tensors there are none). The ring shift
records the all-gather it is made of. Inside ``record_collectives`` a
real mesh's collectives are recorded the same way, and then issued.

**Serving tp** (``init_tp``, ``tp_group``, :func:`all_gather_cat`) is the
reference's ``TP_AXIS`` / ``tp_mesh``: each rank runs the same scheduler
and meets the others in one ``all_gather`` of attention heads a layer
(NCCL with one card a rank, gloo on the CPU).
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import perf
from repro_torch.core import tree as tree_lib

# logical axis -> preferred mesh axes (in order; filtered by mesh presence)
DEFAULT_RULES: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...] = (
    ("batch", ("pod", "data")),      # DP over pods × data axis
    ("embed_fsdp", ("data",)),       # ZeRO-3 parameter shard axis
    ("heads_tp", ("model",)),        # Megatron column split
    ("kv_heads_tp", ("model",)),
    ("vocab_tp", ("model",)),
    ("mlp_tp", ("model",)),
    ("expert", ("model",)),          # EP
    ("kv_seq", None),                # SP: flipped to ("model",) per-config
    ("seq_sp", None),                # context-parallel prefill
    ("stage", ("pod",)),             # pipeline stages (parallel/pipeline.py)
    ("layers", None),                # stacked leading axis
)
BATCH_AXES = ("pod", "data")


def is_spec(x) -> bool:
    """A leaf of an axes or spec tree: a tuple whose entries are None, a
    name or a tuple of names (``is_leaf`` for core/tree.py's walkers)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def spec_axes(spec: Tuple) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` binds, in dimension order."""
    return tuple(a for e in spec for a in _entry_axes(e))


class Line:
    """This rank's line along a set of mesh axes: ``size`` ranks, this one
    at ``index`` (row-major over ``axes``), their process ``group`` (None
    when ``size`` is 1: every collective is then the identity)."""

    def __init__(self, axes: Tuple[str, ...], size: int, index: int,
                 ranks: Tuple[int, ...], group):
        self.axes, self.size, self.index = axes, size, index
        self.ranks, self.group = ranks, group

    def __repr__(self):
        return f"Line({self.axes}, size={self.size}, index={self.index})"


class Mesh:
    """Axis names → sizes, ranks laid out row-major (``jax.make_mesh``'s
    device order). ``Mesh(shape, names)`` spans the running process group
    (whose size must be the mesh's) and makes one group for every line of
    every non-empty set of its axes, on every rank in the same order;
    :meth:`abstract` makes the shape alone."""

    def __init__(self, shape: Sequence[int], names: Sequence[str], *,
                 _abstract: bool = False):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(names)}")
        self.shape: Dict[str, int] = dict(zip(names, (int(s) for s in shape)))
        self.axis_names = tuple(names)
        self.size = math.prod(self.shape.values())
        self.rank: Optional[int] = None
        self._lines: Dict[Tuple[str, ...], Line] = {}
        if _abstract:
            return
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a rank mesh needs a process group: start the "
                               "ranks with parallel/launch.py spawn")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks, "
                             f"the process group {world}")
        self.rank = dist.get_rank()
        me = self.coords()
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                size = math.prod(self.shape[a] for a in axes)
                others = [a for a in self.axis_names if a not in axes]
                mine = None
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    ranks = tuple(self.rank_at({**dict(zip(others, fixed)),
                                                **dict(zip(axes, c))})
                                  for c in itertools.product(
                                      *(range(self.shape[a]) for a in axes)))
                    group = dist.new_group(list(ranks)) if size > 1 else None
                    if self.rank in ranks:
                        mine = (ranks, group)
                index = _row_major([me[a] for a in axes],
                                   [self.shape[a] for a in axes])
                self._lines[axes] = Line(axes, size, index, *mine)

    @classmethod
    def abstract(cls, shape: Sequence[int], names: Sequence[str]) -> "Mesh":
        return cls(shape, names, _abstract=True)

    def rank_at(self, coords: Dict[str, int]) -> int:
        return _row_major([coords[a] for a in self.axis_names],
                          list(self.shape.values()))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The axis coordinates of ``rank`` (default: this process's)."""
        rank = self.rank if rank is None else rank
        if rank is None:
            raise ValueError("an abstract mesh has no rank of its own")
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def line(self, axes) -> Line:
        """This rank's line along ``axes`` (a name or a tuple of names, in
        any order: the line keeps the mesh's)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(axes):
            raise ValueError(f"axes {axes} not all in mesh {self.shape}")
        if not self._lines:
            if _REC.records is None:
                raise ValueError("an abstract mesh has no process groups")
            size = math.prod(self.shape[a] for a in key)
            return Line(key, size, 0, (), None)   # rank 0's, recording
        return self._lines[key]

    def __repr__(self):
        return f"Mesh({self.shape}{', abstract' if self.rank is None else ''})"


def _row_major(coords: Sequence[int], sizes: Sequence[int]) -> int:
    i = 0
    for c, s in zip(coords, sizes):
        i = i * s + c
    return i


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------
class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, Optional[Tuple[str, ...]]] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: Mesh, overrides: Optional[Dict[str, Optional[Tuple[
        str, ...]]]] = None):
    """Activate ``mesh`` and the rules (``overrides`` on the defaults) in
    this thread."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def current_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def current_rules() -> Dict[str, Optional[Tuple[str, ...]]]:
    return dict(_CTX.rules)


def axis_size(mesh_axes: Sequence[str], mesh: Mesh) -> int:
    n = 1
    for a in mesh_axes:
        n *= mesh.shape[a]
    return n


def resolve(axes: Sequence[Optional[str]],
            shape: Optional[Sequence[int]] = None,
            mesh: Optional[Mesh] = None) -> Tuple:
    """Logical axes → a spec under the active rules and mesh (the
    reference's ``resolve``, line for line)."""
    mesh = mesh or _CTX.mesh
    rules = _CTX.rules
    used: set = set()
    out = []
    for i, name in enumerate(axes):
        if name is None or mesh is None:
            out.append(None)
            continue
        pref = rules.get(name)
        if pref is None:
            out.append(None)
            continue
        chosen = tuple(a for a in pref if a in mesh.shape and a not in used)
        if not chosen:
            out.append(None)
            continue
        if shape is not None:
            n = axis_size(chosen, mesh)
            if shape[i] % n != 0:
                # the first axis of the binding that divides, if any
                chosen2 = tuple(a for a in chosen
                                if shape[i] % mesh.shape[a] == 0)[:1]
                if chosen2 and shape[i] % axis_size(chosen2, mesh) == 0:
                    chosen = chosen2
                else:
                    out.append(None)
                    continue
        used.update(chosen)
        out.append(chosen if len(chosen) > 1 else chosen[0])
    return tuple(out)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: each
    rank already holds its own activation, so ``x`` is returned as is."""
    return x


def stack_axes(axes: Tuple[Optional[str], ...],
               n_lead: int = 1) -> Tuple[Optional[str], ...]:
    """Prepend 'layers' axes for stacked params."""
    return ("layers",) * n_lead + tuple(axes)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_slices(shape: Sequence[int], spec: Tuple, mesh: Mesh,
                 rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The slice of a ``shape`` leaf that ``rank`` (default: this one)
    holds under ``spec``: a dimension bound to axes (a0, a1, ...) is cut
    into their product of equal parts, and the rank takes part number
    row-major(its coordinates on a0, a1, ...). On an abstract mesh, rank
    0's (the dry run's traced rank)."""
    coords = mesh.coords(rank) if rank is not None or mesh.rank is not None \
        else {a: 0 for a in mesh.axis_names}
    out = []
    for i, n in enumerate(shape):
        axes = _entry_axes(spec[i] if i < len(spec) else None)
        if not axes:
            out.append(slice(0, n))
            continue
        parts = axis_size(axes, mesh)
        if n % parts:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split {parts} ways ({spec})")
        k = _row_major([coords[a] for a in axes],
                       [mesh.shape[a] for a in axes])
        out.append(slice(k * (n // parts), (k + 1) * (n // parts)))
    return tuple(out)


class Held(NamedTuple):
    """The part ``[lo, hi)`` of a dimension of ``whole`` elements that this
    rank holds, and the ``line`` of the axes that cut it (None when the
    dimension is whole: the op then takes the whole path)."""
    lo: int
    hi: int
    whole: int
    line: Optional[Line]


def held(x, spec: Optional[Tuple], dim: int, mesh: Optional[Mesh]) -> Held:
    """What this rank holds of dimension ``dim`` of its shard ``x`` (a
    tensor or a shape) under ``spec``: the range :func:`shard_slices`
    gives it in the whole leaf, and the line of the bound axes. With no
    spec or no mesh, the whole dimension."""
    shape = tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(x)
    if spec is None or mesh is None:
        return Held(0, shape[dim], shape[dim], None)
    whole = tuple(n * axis_size(_entry_axes(spec[i] if i < len(spec)
                                            else None), mesh)
                  for i, n in enumerate(shape))
    part = shard_slices(whole, spec, mesh)[dim]
    axes = _entry_axes(spec[dim] if dim < len(spec) else None)
    line = mesh.line(axes) if axes and axis_size(axes, mesh) > 1 else None
    return Held(part.start, part.stop, whole[dim], line)


def take(x: torch.Tensor, part: Held, *spans: Tuple[int, int],
         dim: int = -1, apart: bool = False) -> List[torch.Tensor]:
    """The ranges ``spans`` (each ``[lo, hi)`` of the whole dimension
    ``dim``) of ``x``, which holds this rank's ``part`` of that dimension:
    sliced where the part holds them all, else after one gather over the
    part's line: :func:`gather_from` where every rank of the line takes
    the same spans, :func:`gather_shards` with ``apart`` (each rank takes
    its own: the cotangents are summed, the module docstring). Both
    gathers give the same values."""
    if not all(part.lo <= lo and hi <= part.hi for lo, hi in spans):
        x = (gather_shards if apart else gather_from)(x, part.line, dim)
        part = part._replace(lo=0, hi=part.whole)
    return [x.narrow(dim, lo - part.lo, hi - lo) for lo, hi in spans]


def unbind(spec: Tuple, axes: Sequence[str]) -> Tuple:
    """``spec`` with every dimension bound to one of ``axes`` made whole
    (what :func:`gather_leaf` over ``axes`` leaves)."""
    return tuple(None if set(_entry_axes(e)) & set(axes) else e
                 for e in spec)


def shard_of(x, spec: Tuple, mesh: Mesh, rank: Optional[int] = None):
    """A new tensor (or numpy array) holding ``rank``'s slice of ``x``."""
    part = x[shard_slices(tuple(x.shape), spec, mesh, rank)]
    if isinstance(x, torch.Tensor):
        return part.detach().clone()
    return np.array(part, copy=True)


class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: Tuple):
        self.mesh, self.spec = mesh, spec

    def shard_of(self, x):
        return shard_of(x, self.spec, self.mesh)

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> Dict[int, Tuple[slice, ...]]:
        """rank → the slice of a ``shape`` leaf it holds
        (:func:`shard_slices`), every rank in row-major order: the order
        of the reference's ``mesh.devices.flat`` (core/vmm.py's page
        table walks it)."""
        return {r: shard_slices(tuple(shape), self.spec, self.mesh, r)
                for r in range(self.mesh.size)}

    def __repr__(self):
        return f"NamedSharding({self.mesh}, {self.spec})"


def named_sharding(axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None,
                   mesh: Optional[Mesh] = None) -> NamedSharding:
    mesh = mesh or _CTX.mesh
    return NamedSharding(mesh, resolve(axes, shape, mesh))


def tree_shardings(axes_tree, shape_tree=None, mesh: Optional[Mesh] = None):
    """An axes tree (and its leaves' shapes) → a tree of
    :class:`NamedSharding`."""
    mesh = mesh or _CTX.mesh
    if shape_tree is None:
        return tree_lib.tree_map(
            lambda ax: NamedSharding(mesh, resolve(ax, None, mesh)),
            axes_tree, is_leaf=is_spec)
    return tree_lib.tree_map(
        lambda ax, sh: NamedSharding(mesh, resolve(ax, tuple(sh), mesh)),
        axes_tree, shape_tree, is_leaf=is_spec)


# --------------------------------------------------------------------------
# the collectives: on the wire
# --------------------------------------------------------------------------
class _Rec(threading.local):
    def __init__(self):
        self.records: Optional[List[perf.Collective]] = None


_REC = _Rec()


@contextlib.contextmanager
def record_collectives():
    """Record, in this thread, the collectives issued over an abstract
    mesh's lines: yields the list of ``core/perf.Collective`` records,
    filled as the pass runs."""
    prev = _REC.records
    _REC.records = records = []
    try:
        yield records
    finally:
        _REC.records = prev


def _abstract(line: Line, kind: str, result: torch.Tensor) -> bool:
    """Record one ``kind`` collective with ``result``'s bytes inside
    :func:`record_collectives` (on a real line as on an abstract one);
    True on an abstract line (no group, more than one rank: nothing to
    send)."""
    if line.size == 1:
        return False
    if _REC.records is not None:
        _REC.records.append(perf.Collective(
            kind, result.numel() * result.element_size(), line.size))
    if line.group is not None:
        return False
    if _REC.records is None:
        raise ValueError(f"{line}: a collective on an abstract mesh runs "
                         "only inside record_collectives()")
    return True


def _wide(x: torch.Tensor) -> torch.Tensor:
    """A fresh copy to sum in: f32 for a bf16 / f16 ``x``."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x.clone()


def _sum(x: torch.Tensor, line: Line) -> torch.Tensor:
    """Σ over the line, in f32, rounded once to x's dtype."""
    y = _wide(x)
    if not _abstract(line, "all-reduce", y):
        dist.all_reduce(y, group=line.group)
    return y.to(x.dtype)


def _parts(x: torch.Tensor, line: Line) -> List[torch.Tensor]:
    """Every line rank's ``x``, in line order."""
    x = x.contiguous()
    out = torch.empty((line.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    if not _abstract(line, "all-gather", out):
        dist.all_gather_into_tensor(out, x[None], group=line.group)
    return list(out.unbind(0))


def _gather(x: torch.Tensor, line: Line, dim: int) -> torch.Tensor:
    return torch.cat(_parts(x, line), dim=dim)


def _reduce_scatter(x: torch.Tensor, line: Line, dim: int) -> torch.Tensor:
    """This rank's part of Σ over the line of ``x``, cut along ``dim``."""
    n = x.shape[dim] // line.size
    y = _wide(x).movedim(dim, 0).contiguous()
    out = torch.empty((n,) + tuple(y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    if not _abstract(line, "reduce-scatter", out):
        dist.reduce_scatter_tensor(out, y, group=line.group)
    return out.movedim(0, dim).to(x.dtype).contiguous()


def _all_to_all(x: torch.Tensor, line: Line) -> torch.Tensor:
    """Part j of ``x``'s first axis to line rank j; part j of the result
    from line rank j (tiled, as ``jax.lax.all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    if not _abstract(line, "all-to-all", out):
        dist.all_to_all_single(out, x, group=line.group)
    return out


def _shift(x: torch.Tensor, line: Line, shift: int) -> torch.Tensor:
    """Line rank i's ``x`` to rank (i + shift) mod size; returns what rank
    (i - shift) mod size sent: an all-gather and a pick (gloo takes no
    send / recv of a CUDA tensor)."""
    return _parts(x, line)[(line.index - shift) % line.size]


# --------------------------------------------------------------------------
# the collectives: autograd
# --------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.line), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        return _sum(x, line)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim, ctx.n = line, dim, x.shape[dim]
        return _gather(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.line.index * ctx.n,
                        ctx.n).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        n = x.shape[dim] // line.size
        return x.narrow(dim, line.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.line, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _gather(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.line, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return _all_to_all(x, line)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.line), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, shift):
        ctx.line, ctx.shift = line, shift
        return _shift(x, line, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.line, -ctx.shift), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, replicated):
        ctx.line, ctx.replicated = line, replicated
        return _sum(x, line) / line.size

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.line) / ctx.line.size / ctx.replicated, None, None


def copy_to(x: torch.Tensor, line: Line) -> torch.Tensor:
    """``x`` as it is, entering work that differs by rank of the line; the
    backward sums the line's cotangents (Megatron's f)."""
    return x if line.size == 1 else _CopyTo.apply(x, line)


def reduce_from(x: torch.Tensor, line: Line, apart: bool = False
                ) -> torch.Tensor:
    """Σ over the line of the ranks' partial ``x``, which every rank then
    uses alike; the backward passes the cotangent through (Megatron's g).
    With ``apart`` each rank uses the sum on its own part (a norm's
    variance on its channels, a row-parallel product on its heads), so
    the backward sums the cotangents over the line too: an all-reduce
    both ways."""
    if line.size == 1:
        return x
    y = _ReduceFrom.apply(x, line)
    return _CopyTo.apply(y, line) if apart else y


def gather_from(x: torch.Tensor, line: Line, dim: int) -> torch.Tensor:
    """The line's ``x`` concatenated along ``dim`` in line order, which
    every rank then uses alike; the backward takes this rank's part."""
    return x if line.size == 1 else _GatherFrom.apply(x, line, dim)


def split_to(x: torch.Tensor, line: Line, dim: int) -> torch.Tensor:
    """This rank's part of a ``x`` every rank holds alike, cut along
    ``dim``; the backward gathers the parts' cotangents."""
    return x if line.size == 1 else _SplitTo.apply(x, line, dim)


def gather_shards(x: torch.Tensor, line: Line, dim: int) -> torch.Tensor:
    """FSDP's gather: the whole leaf from the line's shards along ``dim``,
    used by each rank on its own rows; the backward reduce-scatters the
    sum of the ranks' cotangents."""
    return x if line.size == 1 else _GatherShards.apply(x, line, dim)


def all_to_all(x: torch.Tensor, line: Line) -> torch.Tensor:
    """The tiled all-to-all over ``x``'s first axis; the backward sends
    the cotangents back."""
    return x if line.size == 1 else _AllToAll.apply(x, line)


def ring_shift(x: torch.Tensor, line: Line, shift: int = 1) -> torch.Tensor:
    """``ppermute`` over the ring ``i → i + shift``; the backward shifts
    the cotangents the other way."""
    return x if line.size == 1 else _Shift.apply(x, line, shift)


def pmean(x: torch.Tensor, line: Line, replicated: int = 1) -> torch.Tensor:
    """The mean over the line. Its backward is the reference's
    ``_pmean_grad_safe``, the mean of the cotangents over the line (each
    batch rank's loss holds the mean once), divided by ``replicated``: the
    size of the line's axes over which one loss is shared (the a2a path's
    ``model``; 1 over batch axes alone)."""
    if line.size == 1:
        return x
    return _PMean.apply(x, line, replicated)


def gather_leaf(x: torch.Tensor, spec: Tuple, mesh: Mesh,
                over: Optional[Sequence[str]] = None,
                alike: bool = False) -> torch.Tensor:
    """A leaf whole from this rank's shard under ``spec``
    (:func:`gather_shards` along each bound dimension; with ``alike``
    :func:`gather_from`, for a leaf the ranks then use alike: the module
    docstring); with ``over``, only the dimensions bound to one of those
    axes (the rest stay this rank's part: ``unbind(spec, over)`` is then
    its spec)."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes and (over is None or set(axes) & set(over)):
            x = (gather_from if alike else gather_shards)(
                x, mesh.line(axes), dim)
    return x


def gather_tree(tree, specs, mesh: Mesh, fn=None,
                over: Optional[Sequence[str]] = None, alike: bool = False):
    """Every leaf of ``tree`` whole (:func:`gather_leaf`, over ``over``'s
    axes alone when given; ``specs`` a tree of ``tree``'s shape; a None
    leaf, a gradient the loss did not reach, stays None), ``fn`` applied
    to each as it arrives (``core/tree.to_host`` for a checkpoint: one
    whole leaf at a time on the device)."""
    fn = fn or (lambda t: t)
    return tree_lib.tree_map(
        lambda t, s: None if t is None else fn(gather_leaf(t, s, mesh,
                                                           over, alike)),
        tree, specs)


@torch.no_grad()
def max_over(x: torch.Tensor, line: Optional[Line]) -> torch.Tensor:
    """The elementwise max over the line's ranks of ``x`` (no gradient:
    the vocabulary-parallel loss's shift, train/loss.py); ``x`` itself
    with no line."""
    if line is None or line.size == 1:
        return x.detach()
    y = x.detach().clone()
    if not _abstract(line, "all-reduce", y):
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=line.group)
    return y


def combine_partials(out: torch.Tensor, lse: torch.Tensor, line: Line
                     ) -> torch.Tensor:
    """The softmax attention over a key axis that the line's ranks hold in
    slices, from each slice's ``out`` [..., hd] and ``lse`` [...] (f32,
    the log of its softmax's denominator: kernels/decode_attention.py
    ``flash_decode(..., return_lse=True)``): both all-gathered over the
    line, each slice weighed by exp(lseᵣ − max), the sum and the division
    in f32, the result cast to ``out``'s dtype. A slice with no visible
    key (lse NEG) weighs 0 beside one that has; when none has, every
    slice weighs 1. Serving only (no gradient)."""
    if line.size == 1:
        return out
    outs = torch.stack(_parts(out, line)).float()
    lses = torch.stack(_parts(lse.float(), line))
    w = torch.exp(lses - lses.amax(dim=0, keepdim=True))
    y = (w[..., None] * outs).sum(dim=0) / w.sum(dim=0)[..., None]
    return y.to(out.dtype)


# --------------------------------------------------------------------------
# serving tensor parallelism (serve/executor.py)
# --------------------------------------------------------------------------
# the wait ``init_tp`` gave the group, which host_group's groups keep
_WAIT: Optional[datetime.timedelta] = None


def init_tp(rank: int, tp: int, store_path: str, backend: str,
            timeout_s: float = 120.0) -> None:
    """Join this process to a ``tp``-rank group through a ``FileStore`` at
    ``store_path`` (a file no other group uses). A collective that waits
    longer than ``timeout_s`` raises instead of hanging."""
    global _WAIT
    store = dist.FileStore(store_path, tp)
    _WAIT = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, store=store, rank=rank, world_size=tp,
                            timeout=_WAIT)


def host_group() -> dist.ProcessGroup:
    """A new gloo group over every rank of the default group, for values
    that live on the host (a CPU tensor on an NCCL group would fail, and
    on a group of its own a host collective never queues behind device
    work). Every rank must call it, in the same order; it waits as long
    as the default group (``init_tp``'s ``timeout_s``)."""
    return dist.new_group(backend="gloo", timeout=_WAIT)


def tp_group(tp: int) -> Optional[dist.ProcessGroup]:
    """The process group a ``tp``-way executor gathers over: the default
    group, which must hold exactly ``tp`` ranks. ``tp = 1`` outside a
    process group gives None (no collective at all); inside a one-rank
    group it gives that group, and the step runs the tp path with one
    shard."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if not (dist.is_available() and dist.is_initialized()):
        if tp == 1:
            return None
        raise RuntimeError(
            f"tp={tp} needs a process group of {tp} ranks: start the ranks "
            "with repro_torch.parallel.launch.spawn (or join them with "
            "init_tp)")
    world = dist.get_world_size()
    if world != tp:
        raise ValueError(f"tp={tp} but the process group has {world} ranks")
    return dist.group.WORLD


def rank_of(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def size_of(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_cat(x: torch.Tensor, group: dist.ProcessGroup,
                   dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order. For the
    attention heads each head was computed whole on one rank, so this is a
    copy, never a reduction: the result is the same bits at any tp."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
