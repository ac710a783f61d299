"""Abstract arguments and shardings for every (arch × shape × mesh) cell.

Counterpart of ``repro/launch/specs.py``. The reference builds
``ShapeDtypeStruct`` trees of the whole arrays and lets XLA partition
them; the port runs one process a rank, so a cell's arguments are what
ONE rank holds: ``meta`` tensors (shapes alone, no memory) at the shard
shape that ``parallel/sharding.resolve`` gives each leaf under the cell's
rules on the mesh (``sharding.tree_shardings`` over ``Mesh.abstract``).
:func:`build_cell` returns the step (train/step.py's train, prefill or
decode step), those arguments and their shardings; :func:`trace_cell`,
the counterpart of ``lower_cell``, runs the step once on them
(core/offload.py ``TargetRegion.trace``: FLOPs, bytes and the collectives
it issues, recorded on the abstract mesh).

A rank's pass is the port's own step. The serving steps run on a rank's
shards (train/step.py ``shard_model``: the batch axes gathered a unit at
a time, the model axis tensor- and sequence-parallel) for GQA, cross,
encoder, MLA and recurrent layers with an MLP or a MoE; so does the train
step (train/step.py ``shard_state``), the model axis tensor-parallel
under autograd down to a vocabulary-parallel loss, the shared block and
the MTP head included. A serving cell whose rules cut what the port's
rank path cannot take has no pass: a ring cache cut over its rows
(``kv_seq`` on a sliding-window layer). :attr:`Cell.gaps` names each such
leaf with the rule that binds it; a cell with gaps is not traced.

On a real device the same function draws the arguments: each leaf drawn
whole from a seed (weights, random tokens) and cut to this rank's shard
(``sharding.shard_of``; on a mesh of one rank the whole leaf), zeroed
caches, ``cache_pos`` S − 1 (a decode step then reads the whole cache).
"""
from __future__ import annotations

import dataclasses
import fractions
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.core import offload, perf
from repro_torch.core import tree as tree_lib
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import ssm, transformer
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.train import step as steps


def cell_config(arch: str, shape: ShapeSpec,
                probe: Optional[Dict[int, int]] = None, smoke: bool = False
                ) -> transformer.ModelConfig:
    """The model config for one cell (+ optional per-group count probe),
    with the reference's overrides. Probe keys index decoder groups first,
    then encoder groups. ``smoke``: the arch's reduced config instead."""
    cfg = (configs.get_smoke_config if smoke else configs.get_config)(arch)
    over: Dict[str, Any] = {}
    MODEL_AXIS = 16
    if shape.step in ("decode", "prefill"):
        # serving holds bf16 weights (no optimizer master copy to protect)
        over["param_dtype"] = torch.bfloat16
    if shape.step == "decode":
        # SP (seq-sharded cache) when KV heads cannot cover the model axis;
        # MLA's latent cache has no head axis; long_500k shards seq always
        if (cfg.n_kv % MODEL_AXIS != 0 or cfg.mla is not None
                or shape.name == "long_500k"):
            over["shard_kv_seq"] = True
    if shape.name == "long_500k":
        over["q_chunk"] = 2048
        over["kv_chunk"] = 2048
    cfg = dataclasses.replace(cfg, **over) if over else cfg
    return cfg if probe is None else _probed(cfg, probe)


def _probed(cfg: transformer.ModelConfig, probe: Dict[int, int]
            ) -> transformer.ModelConfig:
    """``cfg`` with each group's count from ``probe`` (decoder groups
    first, then encoder groups; 1 where it has none)."""
    ng = len(cfg.groups)
    over: Dict[str, Any] = {"groups": tuple(
        (pat, probe.get(i, 1)) for i, (pat, _) in enumerate(cfg.groups))}
    if cfg.encoder_groups:
        over["encoder_groups"] = tuple(
            (pat, probe.get(ng + i, 1))
            for i, (pat, _) in enumerate(cfg.encoder_groups))
    return dataclasses.replace(cfg, **over)


def group_counts(arch: str) -> Tuple[int, ...]:
    cfg = configs.get_config(arch)
    return tuple(c for _, c in cfg.groups) + \
        tuple(c for _, c in cfg.encoder_groups)


def rule_overrides(cfg: transformer.ModelConfig) -> Dict[str, Any]:
    return {"kv_seq": ("model",)} if cfg.shard_kv_seq else {}


# train-cell microbatching (the reference's table)
GRAD_ACCUM = {"deepseek-v3-671b": 16, "yi-34b": 8, "gemma3-27b": 8,
              "llama-3.2-vision-11b": 4, "minitron-4b": 2,
              "granite-moe-3b-a800m": 2, "zamba2-1.2b": 2, "xlstm-1.3b": 2,
              "whisper-medium": 2}


@dataclasses.dataclass
class Cell:
    """One cell: ``fn(*args)`` is one rank's step on ``mesh``.
    ``in_shardings``: a ``NamedSharding`` tree per argument (the model as
    its parameter tree); ``donate``: the arguments the step writes in
    place or replaces (the reference's donated arguments); ``gaps``: the
    leaves whose spec needs a path the port lacks, each as ``"path:
    logical axis -> mesh axes (what is missing)"`` (empty: the cell
    traces)."""
    arch: str
    shape: ShapeSpec
    cfg: transformer.ModelConfig
    fn: Any
    args: Tuple
    in_shardings: Tuple
    mesh: sharding.Mesh
    donate: Tuple[int, ...] = ()
    rules: Optional[Dict[str, Any]] = None
    grad_accum: int = 1
    gaps: Tuple[str, ...] = ()
    levers: Dict[str, Any] = dataclasses.field(default_factory=dict)


def tensor_leaves(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree`` in JAX's order, a model as its parameter
    tree (``transformer.param_tree``)."""
    out = []
    for leaf in tree_lib.leaves(tree):
        if isinstance(leaf, transformer.Transformer):
            out.extend(tensor_leaves(transformer.param_tree(leaf)))
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensor_leaves(tree))


def _specs(axes_tree, shape_tree, mesh):
    return tree_lib.tree_map(lambda sh: sh.spec, sharding.tree_shardings(
        axes_tree, shape_tree, mesh))


def _local(shape, spec, mesh) -> Tuple[int, ...]:
    return tuple(n // sharding.axis_size(sharding._entry_axes(
        spec[i] if i < len(spec) else None), mesh)
        for i, n in enumerate(shape))


def _gaps(prefix: str, axes_tree, spec_tree, mesh: sharding.Mesh,
          allowed: Tuple[str, ...], missing) -> List[str]:
    """The leaves whose spec binds a mesh axis of more than one rank
    outside ``allowed``, each with the reason ``missing(path)`` gives,
    in the dimensions it names (``(reason, dims)``, dims None: all;
    None: the leaf is no gap)."""
    out = []
    for (path, axes), spec in zip(
            tree_lib.paths(axes_tree, prefix, is_leaf=sharding.is_spec),
            tree_lib.leaves(spec_tree, is_leaf=sharding.is_spec)):
        gap = missing(path)
        if gap is None:
            continue
        why, dims = gap
        bad = [f"{axes[i]} -> {'/'.join(sharding._entry_axes(e))}"
               for i, e in enumerate(spec)
               if (dims is None or i in dims) and any(
                   a not in allowed and mesh.shape[a] > 1
                   for a in sharding._entry_axes(e))]
        if bad:
            out.append(f"{path}: {', '.join(bad)} ({why})")
    return out


def _kind(cfg: transformer.ModelConfig, path: str) -> Optional[str]:
    """The mixer of the layer a ``params/groups/...`` or ``caches/...``
    path lies in (None outside the decoder's groups)."""
    parts = path.split("/")
    if parts[0] == "params" and parts[1:2] == ["groups"]:
        gi, pi = int(parts[2]), int(parts[3])
    elif parts[0] == "caches":
        gi, pi = int(parts[1]), int(parts[2])
    else:
        return None
    return transformer.parse_kind(cfg.groups[gi][0][pi])[0]


def _serving_gaps(cfg):
    """``missing(path)`` for the serving steps' leaves: what the rank path
    (``transformer.hidden``) cannot take cut over a non-batch axis."""
    def missing(path: str):
        parts = path.split("/")
        mixer = _kind(cfg, path)
        if mixer is None:
            return None
        if mixer in transformer.RANK_MIXERS:
            return None
        if parts[0] == "params" and "mixer" not in parts:
            return None          # the layer's norms: whole
        return f"a {mixer!r} layer runs whole on a rank: no rank path " \
            "yet", None
    return missing


def _array(shape, dtype, device, generator=None, high: int = 0):
    if device.type == "meta" or generator is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    if high:
        return torch.randint(0, high, shape, generator=generator,
                             device=device, dtype=torch.int64).to(dtype)
    return torch.randn(shape, generator=generator, device=device).to(dtype)


def build_cell(arch: str, shape: ShapeSpec, mesh: sharding.Mesh,
               probe: Optional[Dict[int, int]] = None,
               cfg_over: Optional[Dict[str, Any]] = None,
               rules_over: Optional[Dict[str, Any]] = None,
               grad_accum: Optional[int] = None, device="meta",
               seed: int = 0, smoke: bool = False) -> Cell:
    """One rank's arguments for a cell (rank 0's on an abstract mesh);
    ``cfg_over`` /
    ``rules_over`` / ``grad_accum``: the hillclimb levers
    (launch/hillclimb.py). ``device`` other than ``meta`` draws real
    arguments from ``seed``, each leaf whole and then cut to this rank's
    shard (``mesh`` then a real mesh of ranks, or of one). ``smoke``: the
    arch's reduced config (tests)."""
    device = torch.device(device)
    cfg = cell_config(arch, shape, probe, smoke)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
        if probe is not None:     # the probe's counts over cfg_over's groups
            cfg = _probed(cfg, probe)
    rules = dict(rule_overrides(cfg))
    if rules_over:
        rules.update(rules_over)
    ga = grad_accum if grad_accum is not None else GRAD_ACCUM.get(arch, 1)
    levers = dict(probe=probe, cfg_over=cfg_over, rules_over=rules_over,
                  grad_accum=grad_accum, smoke=smoke)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    batch_axes = tuple(a for a in sharding.BATCH_AXES if a in mesh.shape)
    train = shape.step == "train"
    with sharding.use_mesh(mesh, rules):
        model = transformer.init_model(cfg, gen, device)
        params = transformer.param_tree(model)
        p_axes = transformer.param_axes(cfg)
        p_specs = _specs(p_axes, tree_lib.tree_map(
            lambda p: tuple(p.shape), params), mesh)
        gaps = [] if train else _gaps("params", p_axes, p_specs, mesh,
                                      batch_axes, _serving_gaps(cfg))
        if device.type == "meta":
            for p, spec in zip(tree_lib.leaves(params), tree_lib.leaves(
                    p_specs, is_leaf=sharding.is_spec)):
                local = _local(p.shape, spec, mesh)
                if local != tuple(p.shape):
                    p.data = torch.empty(local, dtype=p.dtype, device=device)
            if mesh.size > 1:
                model.shards = (mesh, p_specs)
        elif mesh.size > 1:
            steps.shard_model(model, mesh)
        p_sh = tree_lib.tree_map(lambda s: sharding.NamedSharding(mesh, s),
                                 p_specs, is_leaf=sharding.is_spec)
        B = shape.global_batch
        L = shape.seq_len if shape.step != "decode" else 1
        tok_spec = sharding.resolve(("batch", None), (B, L), mesh)
        b_local = _local((B, L), tok_spec, mesh)
        if train:       # each microbatch cut as the reference constrains it
            b_local = (B // sharding.axis_size(
                steps.microbatch_axes(B // ga, mesh), mesh), L)

        def cut(whole, spec, local):
            if device.type == "meta":
                return torch.zeros(local, dtype=whole.dtype, device=device)
            if train:
                return steps.rank_rows({"tokens": whole}, ga,
                                       mesh)["tokens"]
            return sharding.shard_of(whole, spec, mesh)

        def tokens():
            return cut(_array((B, L), torch.int32, device, gen, cfg.vocab),
                       tok_spec, b_local)

        extra = None
        if transformer.has_cross(cfg) and shape.step != "decode":
            dim = cfg.cross_kv_dim if cfg.family == "vlm" else cfg.d_model
            ex_spec = sharding.resolve(("batch", None, None),
                                       (B, cfg.encoder_seq, dim), mesh)
            ex_local = (b_local[0],) + _local((B, cfg.encoder_seq, dim),
                                              ex_spec, mesh)[1:]
            extra = cut(_array((B, cfg.encoder_seq, dim), torch.bfloat16,
                               device, gen), ex_spec, ex_local)
        if train:
            model.requires_grad_(True)
            state = steps.TrainState(params=model, opt=adamw.init(params),
                                     step=torch.zeros((), dtype=torch.int32,
                                                      device=device))
            batch = {"tokens": tokens(), "labels": tokens()}
            if cfg.mtp:
                batch["next_tokens"] = tokens()
                batch["mtp_labels"] = tokens()
            if extra is not None:
                batch["extra"] = extra
            fn = steps.make_train_step(cfg, adamw.Config(), grad_accum=ga)
            b_sh = {k: sharding.NamedSharding(
                mesh, ex_spec if k == "extra" else tok_spec) for k in batch}
            state_sh = steps.TrainState(
                params=p_sh, opt=adamw.OptState(m=p_sh, v=p_sh),
                step=sharding.NamedSharding(mesh, ()))
            return Cell(arch, shape, cfg, fn, (state, batch),
                        (state_sh, b_sh), mesh, donate=(0,), rules=rules,
                        grad_accum=ga, gaps=tuple(gaps), levers=levers)
        S = shape.seq_len
        caches, c_specs = steps.rank_caches(cfg, B, S, mesh, device=device)
        gaps += _gaps("caches", transformer.cache_logical_axes(cfg), c_specs,
                      mesh, batch_axes, _serving_gaps(cfg))
        c_sh = tree_lib.tree_map(lambda s: sharding.NamedSharding(mesh, s),
                                 c_specs, is_leaf=sharding.is_spec)
        tok_sh = sharding.NamedSharding(mesh, tok_spec)
        if shape.step == "prefill":
            fn = steps.make_prefill_step(cfg, c_specs)
            return Cell(arch, shape, cfg, fn, (model, tokens(), caches,
                                               extra),
                        (p_sh, tok_sh, c_sh, None if extra is None else
                         sharding.NamedSharding(mesh, ex_spec)),
                        mesh, donate=(2,), rules=rules, gaps=tuple(gaps), levers=levers)
        pos = torch.full((), S - 1, dtype=torch.int32, device=device)
        fn = steps.make_decode_step(cfg, c_specs)
        return Cell(arch, shape, cfg, fn, (model, tokens(), caches, pos),
                    (p_sh, tok_sh, c_sh, sharding.NamedSharding(mesh, ())),
                    mesh, donate=(2,), rules=rules, gaps=tuple(gaps), levers=levers)


def memory(cell: Cell, trace: Optional[offload.Trace] = None
           ) -> Dict[str, Optional[int]]:
    """One rank's bytes. Exact from the shard shapes: the arguments; the
    outputs, which are the donated arguments' new values (``alias``, as the
    reference donates them: the caches, or the train state) and, for a
    serving step, the logits [B_local, 1, vocab] at the compute dtype (a
    train step's metrics are a few scalars, not counted). From a traced
    pass (None: not traced): temp, the most bytes alive at once less the
    new outputs (``output - alias``), so that ``total_per_device`` is the
    arguments plus that peak. The bytes alive are the storages the pass
    created and, at each hand-written kernel's launch, the scratch it
    allocates for itself on the card, which its ``meta`` branch reports
    (``trace.scratch_peak_bytes``: ``flash_decode``'s split partials)."""
    arg = nbytes(cell.args)
    alias = sum(nbytes(cell.args[i]) for i in cell.donate)
    out = alias
    if cell.shape.step != "train":
        out += cell.args[1].shape[0] * cell.cfg.vocab * \
            cell.cfg.compute_dtype.itemsize
    temp = None if trace is None else max(
        0, max(trace.peak_bytes, trace.scratch_peak_bytes) - (out - alias))
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "temp_size_in_bytes": temp, "alias_size_in_bytes": alias,
            "total_per_device": arg + out - alias + (temp or 0)}


# A prefill or a train step through a recurrent layer loops in Python a
# chunk (gla_chunked) or a token (the sLSTM) at a time, each step the same
# ops on the same shapes: on ``meta`` a 32k-token pass is some half a
# million ops a layer, and xlstm-1.3b's train_4k pass (its sLSTMs' 4096
# steps, forward, recompute and backward, in each microbatch) passed 12
# minutes. trace_cell traces such a cell at these multiples of its period
# instead and fits the counts (:func:`_fitted`); a pass of one period is
# left out, since one chunk's pass differs in a few bytes from the rest.
FIT_PERIODS = (2, 3, 4)


def _through(points, x):
    """The polynomial through ``points`` [(x_i, f_i)] at ``x``, Lagrange's
    form in exact rationals: the fits' counts are integers (or floats that
    hold integers) and so is every weight at an integer ``x``. A float
    where any f_i is one, else an int."""
    total = fractions.Fraction(0)
    for i, (xi, fi) in enumerate(points):
        w = fractions.Fraction(fi)
        for j, (xj, _) in enumerate(points):
            if j != i:
                w *= fractions.Fraction(x - xj, xi - xj)
        total += w
    return float(total) if any(isinstance(f, float) for _, f in points) \
        else int(total)


def _fit_period(cell: Cell) -> Optional[int]:
    """The period P (tokens) of a ``meta`` prefill or train cell through
    recurrent layers that :func:`trace_cell` fits, or None: the least
    common multiple of the recurrent mixers' chunks and, where the model
    attends, the attention's largest block (flash_attention's in a
    prefill, ``flash_xla``'s chunks in training: its plan of blocks is
    then the same at every multiple of P), where the cell's length is a
    multiple of P past the longest fitted pass. A MoE's capacity steps
    with the tokens, so a model with one is not fitted."""
    cfg, L = cell.cfg, cell.shape.seq_len
    mixers = {transformer.parse_kind(kind)[0]
              for pattern, _ in cfg.groups for kind in pattern}
    train = cell.shape.step == "train"
    tokens = cell.args[1]["tokens"] if train else cell.args[1]
    if (cell.shape.step not in ("prefill", "train")
            or not mixers & set(ssm.RECURRENT)
            or transformer.couples_rows(cfg)
            or tokens.device.type != "meta"):
        return None
    attends = bool(mixers - set(ssm.RECURRENT))
    blocks = (cfg.q_chunk, cfg.kv_chunk) if train else (max(fa.BLOCKS),)
    P = math.lcm(*(blocks if attends else ()),
                 *(getattr(cfg, m).chunk for m in ("mamba", "mlstm")
                   if m in mixers))
    return P if L % P == 0 and L // P > FIT_PERIODS[-1] else None


def _fitted(cell: Cell, P: int) -> offload.Trace:
    """The pass of ``cell`` (n = L / P periods) from passes of the same cell
    at ``FIT_PERIODS`` (2, 3 and 4 periods): each count (FLOPs, the
    kernels' own by name, bytes, each collective's bytes) the quadratic in
    n through them, exact for steps that repeat (linear in n) and for
    attention's causal walk over whole blocks (quadratic), in a prefill
    and in a train step alike; the peaks
    (``peak_bytes``, ``scratch_peak_bytes``) the line through the two
    longest. No outputs; ``seconds`` the three passes'."""
    n = cell.shape.seq_len // P
    t2, t3, t4 = (_traced(build_cell(
        cell.arch, dataclasses.replace(cell.shape, seq_len=m * P),
        cell.mesh, **cell.levers)) for m in FIT_PERIODS)

    def quad(*f):
        return _through(list(zip(FIT_PERIODS, f)), n)

    def line(f3, f4):
        return _through([(3, f3), (4, f4)], n)

    colls = []
    assert len(t2.collectives) == len(t3.collectives) == \
        len(t4.collectives), (cell.arch, cell.shape.name)
    for c2, c3, c4 in zip(t2.collectives, t3.collectives, t4.collectives):
        assert (c2.kind, c2.group) == (c3.kind, c3.group) == \
            (c4.kind, c4.group), (c2, c3, c4)
        colls.append(perf.Collective(c4.kind, quad(c2.nbytes, c3.nbytes,
                                                   c4.nbytes), c4.group))
    kernel_flops = {k: quad(*(t.kernel_flops.get(k, 0) for t in
                              (t2, t3, t4))) for k in t4.kernel_flops}
    return offload.Trace(
        quad(t2.flops, t3.flops, t4.flops), kernel_flops,
        quad(t2.bytes, t3.bytes, t4.bytes),
        line(t3.peak_bytes, t4.peak_bytes), colls, None,
        t2.seconds + t3.seconds + t4.seconds,
        line(t3.scratch_peak_bytes, t4.scratch_peak_bytes))


# A train cell's eager pass on ``meta`` visits every layer of every
# microbatch (yi-34b and gemma3-27b train_4k: some 500 layer passes, ~8
# minutes a mesh); past this many, trace_cell fits the pass instead
# (:func:`_fitted_train`).
TRAIN_FIT_PASSES = 100


def _layer_passes(cell: Cell) -> int:
    return cell.grad_accum * sum(len(pattern) * count for pattern, count in
                                 cell.cfg.groups + cell.cfg.encoder_groups)


def _fitted_train(cell: Cell) -> offload.Trace:
    """The train step of ``cell`` (G = grad_accum microbatches of b rows,
    N_i units of group i) from passes of the same cell with 1, 2 or 3
    units of one group (the others at 1), each at 2 and 3 microbatches of
    the same b rows. Each count (FLOPs, the kernels' own, bytes, the
    number and the bytes of the collectives of each kind and group size)
    is linear in the microbatches (a microbatch's part and the step's own:
    the optimizer, the gradients' sums, the norm), taken at G through 2
    and 3, and is the base pass's plus, for each group, a quadratic in its
    units through 1, 2 and 3 less the base (the bytes are quadratic: each
    unit's backward writes its group's whole stacked gradient); exact, as
    the work repeats a unit and a microbatch at a time (one microbatch
    skips the step's mean over them, so no pass takes one). The peaks are
    extrapolated the same way. The collectives come back grouped by kind
    and group size, each of their mean size (``perf.collective_bytes`` of
    them exact), not in issue order."""
    groups = cell.cfg.groups + cell.cfg.encoder_groups
    b = cell.shape.global_batch // cell.grad_accum
    G = cell.grad_accum
    seconds = []

    def counts(probe, g):
        levers = dict(cell.levers, probe=probe, grad_accum=g)
        shape = dataclasses.replace(cell.shape, global_batch=b * g)
        t = _traced(build_cell(cell.arch, shape, cell.mesh, **levers))
        seconds.append(t.seconds)
        c = dict(t.kernel_flops, _flops=t.flops, _bytes=t.bytes,
                 _peak=t.peak_bytes, _scratch=t.scratch_peak_bytes)
        for r in t.collectives:
            for key, v in ((("n", r.kind, r.group), 1),
                           (("bytes", r.kind, r.group), r.nbytes)):
                c[key] = c.get(key, 0) + v
        return c

    def at_G(probe):    # each count at G microbatches, through 2 and 3
        c2, c3 = counts(probe, 2), counts(probe, 3)
        return {k: _through([(2, c2.get(k, 0)), (3, c3.get(k, 0))], G)
                for k in set(c2) | set(c3)}

    base = {i: 1 for i in range(len(groups))}
    one = at_G(base)
    more = [(at_G({**base, i: 2}), at_G({**base, i: 3}))
            for i in range(len(groups))]
    fitted = {}
    for k in set(one).union(*(set(a) | set(c) for a, c in more)):
        v1 = one.get(k, 0)
        fitted[k] = v1 + sum(
            _through([(1, v1), (2, two.get(k, 0)), (3, three.get(k, 0))],
                     n) - v1
            for (_, n), (two, three) in zip(groups, more))
    colls = []
    for k in sorted(k for k in fitted if isinstance(k, tuple)
                    and k[0] == "n"):
        n, total = int(fitted[k]), int(fitted[("bytes",) + k[1:]])
        colls += [perf.Collective(k[1], total // n + (i < total % n),
                                  k[2]) for i in range(n)]
    return offload.Trace(
        fitted["_flops"], {k: v for k, v in fitted.items()
                           if isinstance(k, str) and k[0] != "_"},
        fitted["_bytes"], fitted["_peak"], colls, None, sum(seconds),
        fitted["_scratch"])


def _traced(cell: Cell) -> offload.Trace:
    """The one pass of :func:`trace_cell`, at the cell's own length."""
    region = offload.TargetRegion(cell.fn, name=f"{cell.arch}/"
                                  f"{cell.shape.name}")
    with sharding.use_mesh(cell.mesh, cell.rules):
        return region.trace(*cell.args)


def trace_cell(cell: Cell) -> offload.Trace:
    """Run one rank's step on the cell's arguments (the counterpart of
    ``lower_cell``) under its mesh and rules: FLOPs, bytes, collectives
    and outputs of the pass. A long ``meta`` prefill through a recurrent
    layer is fitted from short passes (:func:`_fitted`), and so is a
    ``meta`` train step of more than :data:`TRAIN_FIT_PASSES` layer
    passes (:func:`_fitted_train`)."""
    if cell.gaps:
        raise ValueError(f"{cell.arch} x {cell.shape.name}: no traced pass "
                         f"on {cell.mesh}: {cell.gaps[0]}")
    if cell.shape.step == "train" and \
            cell.args[1]["tokens"].device.type == "meta" and \
            _layer_passes(cell) > TRAIN_FIT_PASSES:
        return _fitted_train(cell)
    P = _fit_period(cell)
    return _traced(cell) if P is None else _fitted(cell, P)
