"""The train step, and the prefill and decode steps.

Counterpart of ``repro/train/step.py``. **Training**: :class:`TrainState`
(the model, its f32 master weights trainable, the AdamW moments and the
step), :func:`make_loss_fn` (the training forward, models/transformer.py
``train_forward``, then train/loss.py's ``lm_loss`` with the MoE aux and
deepseek's MTP term) and :func:`make_train_step` (forward and backward,
``grad_accum`` microbatches with their gradients summed in f32 and
averaged, an optional gradient compressor, then optim/adamw.py)::

    state = init_state(transformer.init_model(cfg, gen, "cuda"))
    train_step = make_train_step(cfg, adamw.Config(lr=3e-4), grad_accum=2)
    state, metrics = train_step(state, {"tokens": t, "labels": y})

The step writes the new weights into the model's parameters in place and
returns the state with its new moments and step; ``metrics`` holds the
loss terms, ``grad_norm``, ``lr`` and ``tokens`` (0-d tensors but
``tokens``). :func:`state_tree` / :func:`load_state` carry a state to and
from the reference's tree (checkpoint/manager.py).

**Data parallelism in the FSDP layout** (the reference's train driver on a
(data, 1) mesh, its state under ``tree_shardings``): :func:`shard_state`
cuts every weight, m and v leaf to this rank's shard as
``sharding.resolve`` binds its logical axes (models/transformer.py
``param_axes``: ``embed_fsdp`` over ``data``; a leaf whose dimension does
not divide stays whole), and the same ``make_train_step`` then runs the
FSDP step on the rank's rows (:func:`rank_rows`): the training forward
all-gathers each leaf where it is used, inside each unit's remat region;
the backward reduce-scatters each sharded leaf's gradient and the step
sums a whole leaf's over the batch ranks, both then divided into the mean
over them; the clip takes the norm over every shard, the compressor each
whole leaf (its int8 blocks are the whole flattened leaf's), and AdamW
updates the shards. The loss and the metrics are the means over the
global batch. :func:`whole_state` / :func:`state_shardings` carry a
sharded state to and from a checkpoint's whole leaves::

    state = shard_state(init_state(model), mesh)     # every rank
    state, m = train_step(state, rank_rows(batch, grad_accum, mesh))

**With a model axis** (the reference's step jitted under its rules on a
(data, model) or (pod, data, model) mesh, partitioned by GSPMD): under
``sharding.use_mesh(mesh, rules)`` :func:`shard_state` also cuts the
leaves the rules bind to ``model`` (heads, kv heads, the MLP's hidden,
the vocabulary, the experts, the recurrent mixers' heads), every rank of
a model line takes the same rows (:func:`rank_rows`), and the training
forward runs that axis tensor-parallel under autograd
(models/transformer.py ``train_forward``: every layer kind, the encoder,
the shared block and the MTP head included) down to a
vocabulary-parallel loss (train/loss.py). The
gradient is summed over the free batch axes only and the metrics are
reduced over the batch line only::

    with sharding.use_mesh(mesh, rules):
        state = shard_state(init_state(model), mesh)
        state, m = train_step(state, rank_rows(batch, grad_accum, mesh))

**Serving**: ``make_prefill_step`` / ``make_decode_step``
(``step.py:93-110``), which
the reference's dry-run lowers for its prefill / decode cells and through
which it runs llama-3.2-vision-11b and whisper-medium: no serving engine
of either package takes their encoder input (``extra``). They run the
recurrent archs (xlstm-1.3b, zamba2-1.2b) as they stand, each layer's
state in the caches, and deepseek-v3's MLA layers over their latent
caches. Both steps are
plain functions over the port's
:class:`~repro_torch.models.transformer.Transformer` and the dense slot
caches of :func:`~repro_torch.models.transformer.init_caches` (written in
place), whose weights must already be at the config's compute dtype; both
run under ``torch.no_grad()``::

    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    caches = transformer.init_caches(cfg, B, max_seq, device="cuda")
    logits, caches = prefill(model, prompts, caches, extra=frames)
    tok = logits[:, -1].argmax(-1)[:, None]
    for pos in range(L, L + n):
        logits, caches = decode(model, tok, caches, pos)
        tok = logits[:, -1].argmax(-1)[:, None]

**Serving on one rank of a mesh** (the reference's steps jitted under
its rules, partitioned by GSPMD): :func:`shard_model` cuts the model to
this rank's shards under the active rules (or models/convert.py
``rank_params_from_numpy`` from the reference's tree) and
:func:`rank_caches` gives the rank's part of the caches with their specs;
the same steps, made with those specs, then run under the mesh on the
rank's rows (models/transformer.py ``hidden``)::

    with sharding.use_mesh(mesh, rules):
        model = shard_model(model, mesh)
        caches, specs = rank_caches(cfg, B, max_seq, mesh, device="cuda")
        logits, caches = make_decode_step(cfg, specs)(model, tok, caches,
                                                      pos)

:func:`attention_calls` lists the attention-kernel calls such a run makes,
shape by shape, so that each kernel can be held against its plain version
at exactly those shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.models import ssm, transformer
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.train import loss as loss_lib


@dataclasses.dataclass
class TrainState:
    """``params``: the :class:`~repro_torch.models.transformer.Transformer`
    (master weights at ``param_dtype``, trainable); ``opt``: the AdamW
    moments as trees of the reference's layout; ``step``: a 0-d int32
    tensor on the model's device."""
    params: Any
    opt: adamw.OptState
    step: torch.Tensor


def init_state(model) -> TrainState:
    """A fresh state over ``model``: its weights made trainable, zero
    moments, step 0."""
    model.requires_grad_(True)
    return TrainState(params=model,
                      opt=adamw.init(transformer.param_tree(model)),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.embed.device))


def state_tree(state: TrainState) -> TrainState:
    """The state as the reference's ``TrainState`` tree (the model as its
    parameter tree), tensor leaves: what a checkpoint holds, keyed
    ``.params/...``, ``.opt/.m/...``, ``.opt/.v/...``, ``.step``."""
    return TrainState(params=transformer.param_tree(state.params),
                      opt=state.opt, step=state.step)


@torch.no_grad()
def load_state(state: TrainState, host: TrainState) -> TrainState:
    """Copy ``host`` (a :func:`state_tree` of numpy leaves, as
    ``CheckpointManager.restore`` gives it) into ``state``'s tensors in
    place; returns ``state``."""
    for t, a in zip(tree_lib.leaves(state_tree(state)),
                    tree_lib.leaves(host)):
        t.copy_(torch.from_numpy(np.asarray(a)))
    return state


def param_specs(model, mesh: sharding.Mesh) -> Any:
    """The spec of each leaf of :func:`transformer.param_tree` on
    ``mesh``: its logical axes (``transformer.param_axes``) resolved
    against its whole shape (``sharding.tree_shardings``)."""
    shapes = tree_lib.tree_map(lambda p: tuple(p.shape),
                               transformer.param_tree(model))
    return tree_lib.tree_map(lambda sh: sh.spec, sharding.tree_shardings(
        transformer.param_axes(model.cfg), shapes, mesh))


def shard_model(model, mesh: sharding.Mesh):
    """``model`` (whole leaves) cut to this rank's shards in place: each
    weight's data replaced by the slice ``resolve`` gives it on ``mesh``
    under the active rules (a leaf whose dimension does not divide stays
    whole); ``model.shards`` set. Returns the model: the prefill and
    decode steps then run it on this rank (the module docstring)."""
    specs = param_specs(model, mesh)
    with torch.no_grad():
        for p, spec in zip(tree_lib.leaves(transformer.param_tree(model)),
                           tree_lib.leaves(specs, is_leaf=sharding.is_spec)):
            p.data = sharding.shard_of(p.data, spec, mesh)
    model.shards = (mesh, specs)
    return model


def init_shards(cfg: transformer.ModelConfig, mesh: sharding.Mesh,
                generator: Optional[torch.Generator] = None, device=None):
    """This rank's shards of the model ``transformer.init_model(cfg,
    generator, device)`` draws, each leaf made at its shard's shape alone
    (``init_model``'s ``part``: a piece of a leaf's draw at a time, so no
    whole leaf is on the device), ``model.shards`` set: what
    :func:`shard_model` gives that model, for a model whose whole leaves
    would not fit beside the other ranks' shards."""
    meta = transformer.init_model(cfg, device="meta")
    specs = param_specs(meta, mesh)
    shapes = tree_lib.tree_map(lambda t: tuple(t.shape),
                               transformer.param_tree(meta))

    def part(path):
        spec, shape = specs, shapes
        for key in path:
            spec, shape = spec[key], shape[key]
        return sharding.shard_slices(shape, spec, mesh)
    model = transformer.init_model(cfg, generator, device, part=part)
    model.shards = (mesh, specs)
    return model


def shard_state(state: TrainState, mesh: sharding.Mesh) -> TrainState:
    """``state`` (whole leaves) cut to this rank's shards in place: each
    weight's data, m and v replaced by the slice ``resolve`` gives it on
    ``mesh`` under the active rules (a (data, model) or (pod, data,
    model) mesh; the caller's ``sharding.use_mesh(mesh, rules)``, or the
    default rules); ``state.params.shards`` set. Returns the state."""
    model = shard_model(state.params, mesh)
    specs = model.shards[1]
    cut = lambda t, spec: sharding.shard_of(t, spec, mesh)
    return TrainState(params=model, opt=adamw.OptState(
        m=tree_lib.tree_map(cut, state.opt.m, specs),
        v=tree_lib.tree_map(cut, state.opt.v, specs)), step=state.step)


def state_specs(specs) -> TrainState:
    """The spec of each leaf of :func:`state_tree` from the weights'
    (:func:`param_specs`): m and v lie as their weights, the step whole."""
    return TrainState(params=specs, opt=adamw.OptState(m=specs, v=specs),
                      step=())


def state_shardings(state: TrainState) -> TrainState:
    """A sharded state's specs on its mesh (``CheckpointManager.
    restore``'s ``shardings``: each rank reads its slice of each whole
    leaf)."""
    mesh, specs = state.params.shards
    return tree_lib.tree_map(lambda s: sharding.NamedSharding(mesh, s),
                             state_specs(specs), is_leaf=sharding.is_spec)


@torch.no_grad()
def whole_state(state: TrainState, keep: bool = True) -> TrainState:
    """A sharded state's :func:`state_tree` as whole host leaves (every
    rank takes part; one whole leaf at a time on the device): what a
    checkpoint holds, as the reference's host arrays are whole. A rank
    with ``keep`` False takes part and keeps nothing (None leaves)."""
    mesh, specs = state.params.shards
    return sharding.gather_tree(
        state_tree(state), state_specs(specs), mesh,
        fn=tree_lib.to_host if keep else (lambda t: None))


def microbatch_axes(rows: int, mesh: sharding.Mesh) -> Tuple[str, ...]:
    """The batch axes a microbatch of ``rows`` rows is cut over: the
    reference constrains each microbatch to ``("batch", None)`` at its
    own shape, so ``resolve``'s binding (every batch axis where their
    product divides the rows, else the first that does, else none: the
    rows are then alike on the ranks of the rest)."""
    return sharding.spec_axes(sharding.resolve(("batch",), (rows,), mesh))


def rank_rows(batch: Dict, grad_accum: int, mesh: sharding.Mesh) -> Dict:
    """This rank's rows of a global ``batch``, as the reference's data
    shard holds them: microbatch m (rows m·B/grad_accum onward, the
    train step's split) cut into equal parts over the batch axes
    :func:`microbatch_axes` gives it, this rank's part of each, in
    microbatch order (deepseek-v3-671b's 16 microbatches of 16 rows on
    2x16x16 are cut over ``pod`` alone, each half alike on the 16 ranks
    of ``data``, as the reference's constraint leaves them)."""
    B = batch["tokens"].shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} does not split into {grad_accum} "
                         f"microbatches")
    mb = B // grad_accum
    axes = microbatch_axes(mb, mesh)
    line = mesh.line(axes) if axes else sharding.Line((), 1, 0, (), None)
    if mb % line.size:
        raise ValueError(f"a microbatch of {mb} rows does not split over "
                         f"{line.size} batch ranks")
    part = mb // line.size
    rows = np.concatenate([np.arange(m * mb + line.index * part,
                                     m * mb + (line.index + 1) * part)
                           for m in range(grad_accum)])
    return {k: v[rows] if isinstance(v, np.ndarray)
            else v[torch.from_numpy(rows).to(v.device)]
            for k, v in batch.items()}


def _reduce_grads(grads, specs, mesh: sharding.Mesh, n: int):
    """Each gradient shard summed over the batch ranks its leaf is not
    sharded over (a sharded leaf's backward already reduce-scattered it
    over the rest), then divided by ``n``. Never over the model axis: a
    shard cut over it holds its own gradient whole, and a leaf every rank
    of a model line uses alike (a norm, ``b_out`` after the row sum, the
    router) the same whole gradient on each (parallel/sharding.py's
    module docstring)."""
    batch = tuple(a for a in sharding.BATCH_AXES if a in mesh.shape)

    def red(g, spec):
        if g is None:
            return None
        free = tuple(a for a in batch if a not in sharding.spec_axes(spec))
        if free:
            g = sharding.reduce_from(g, mesh.line(free))
        return g / n
    return tree_lib.tree_map(red, grads, specs)


def _global_norm(grads, specs, mesh: sharding.Mesh) -> torch.Tensor:
    """sqrt(Σ leaf²) over every shard of every leaf: each leaf's local
    sum of squares summed over the ranks of the axes it is sharded on
    (and no others, so a leaf whole on a line counts once)."""
    by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, spec in zip(tree_lib.leaves(grads),
                       tree_lib.leaves(specs, is_leaf=sharding.is_spec)):
        if g is not None:
            key = sharding.spec_axes(spec)
            s = torch.sum(torch.square(g.float()))
            by_axes[key] = s if key not in by_axes else by_axes[key] + s
    total = None
    for key, s in by_axes.items():
        if key:
            s = sharding.reduce_from(s, mesh.line(key))
        total = s if total is None else total + s
    return torch.sqrt(total)


def make_loss_fn(cfg: transformer.ModelConfig, mtp_weight: float = 0.3):
    """``loss_fn(model, batch) -> (loss, metrics)``: batch ``tokens`` /
    ``labels`` [B, L], optional ``extra`` (encoder input),
    ``next_tokens`` / ``mtp_labels`` (deepseek's MTP head)."""
    def loss_fn(model, batch):
        tokens = sharding.constrain(batch["tokens"], "batch", None)
        labels = sharding.constrain(batch["labels"], "batch", None)
        nxt = batch.get("next_tokens")
        logits, aux = transformer.forward(
            model, tokens, mode="train", extra=batch.get("extra"),
            next_tokens=nxt)
        if cfg.mtp and nxt is not None:
            aux["mtp_labels"] = batch.get("mtp_labels")
        return loss_lib.lm_loss(logits, labels, aux, mtp_weight=mtp_weight)
    return loss_fn


def make_train_step(cfg: transformer.ModelConfig, opt_cfg: adamw.Config,
                    grad_accum: int = 1, compressor=None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) -> (state', metrics)``.

    ``grad_accum`` > 1 cuts the batch into that many microbatches of
    consecutive rows (the reference's ``reshape((grad_accum, B /
    grad_accum) + ...)``), one forward and backward each, their gradients
    summed into the f32 leaves' ``.grad`` and divided by ``grad_accum``;
    the loss and each metric are the microbatches' mean. ``compressor``
    (parallel/compression.py) takes the gradient tree before the
    optimizer, which steps a leaf at a time (the same values as one
    ``adamw.update`` of the tree, never every leaf's new weights and
    moments at once). A state from :func:`shard_state` takes the step on
    this rank's rows (the module docstring) under its mesh: the caller's
    ``sharding.use_mesh(mesh, rules)`` where it is active, else the mesh
    with the default rules."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState,
                                                            Dict]:
        model = state.params
        mesh = None if model.shards is None else model.shards[0]
        params = transformer.param_tree(model)
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.grad = None
        B = batch["tokens"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} does not split into "
                             f"{grad_accum} microbatches")
        mb, runs = B // grad_accum, []
        with contextlib.ExitStack() as ctx:
            if mesh is not None and sharding.current_mesh() is not mesh:
                ctx.enter_context(sharding.use_mesh(mesh))
            for i in range(grad_accum):
                loss, m = loss_fn(model, batch if grad_accum == 1 else
                                  {k: v[i * mb:(i + 1) * mb]
                                   for k, v in batch.items()})
                loss.backward()
                runs.append({k: v.detach() for k, v in m.items()})
        metrics = runs[0] if grad_accum == 1 else {
            k: torch.stack([r[k] for r in runs]).mean() for k in runs[0]}
        grads = tree_lib.unflatten(params, [
            None if p.grad is None else
            (p.grad if grad_accum <= 1 else p.grad / grad_accum)
            for p in leaves])
        gnorm, ranks = None, 1
        if mesh is not None:
            specs = model.shards[1]
            line = mesh.line(tuple(a for a in sharding.BATCH_AXES
                                   if a in mesh.shape))
            ranks = line.size
            grads = _reduce_grads(grads, specs, mesh, ranks)
            metrics = {k: sharding.reduce_from(v, line) / ranks
                       for k, v in metrics.items()}
            if compressor is not None:    # int8 blocks of the whole leaf
                with torch.no_grad():
                    grads = tree_lib.tree_map(
                        lambda g, spec: None if g is None else
                        sharding.shard_of(g, spec, mesh),
                        compressor(sharding.gather_tree(grads, specs, mesh)),
                        specs)
            gnorm = _global_norm(grads, specs, mesh)
        elif compressor is not None:
            grads = compressor(grads)
        if gnorm is None:
            gnorm = adamw.global_norm(grads)
        # AdamW a leaf at a time, each new weight written and its gradient
        # let go before the next leaf's step: the new weights and moments
        # of every leaf are never held at once (12 B a parameter)
        grads = tree_lib.leaves(grads)
        ms, vs = tree_lib.leaves(state.opt.m), tree_lib.leaves(state.opt.v)
        for i, p in enumerate(leaves):
            new, opt, opt_metrics = adamw.update(
                [grads[i]], adamw.OptState([ms[i]], [vs[i]]), [p],
                state.step, opt_cfg, gnorm=gnorm)
            with torch.no_grad():
                p.copy_(new[0])
            ms[i], vs[i], grads[i], p.grad = opt.m[0], opt.v[0], None, None
        metrics = dict(metrics, **opt_metrics,
                       tokens=float(batch["tokens"].numel() * ranks))
        new_opt = adamw.OptState(tree_lib.unflatten(params, ms),
                                 tree_lib.unflatten(params, vs))
        return TrainState(params=model, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step


def _check_dtype(cfg: transformer.ModelConfig, model) -> None:
    if model.embed.dtype != cfg.compute_dtype:
        raise ValueError(f"{cfg.name}: the model's weights are "
                         f"{model.embed.dtype}, the compute dtype "
                         f"{cfg.compute_dtype}: cast them first "
                         "(model.to(dtype=cfg.compute_dtype))")


def rank_caches(cfg: transformer.ModelConfig, batch: int, max_seq: int,
                mesh: sharding.Mesh, dtype=None, device=None):
    """This rank's zeroed part of the slot caches of ``batch`` slots ×
    ``max_seq`` rows on ``mesh`` (its slots, kv heads and rows) and the
    spec of each leaf under the active rules (its logical axes,
    ``transformer.cache_logical_axes``, resolved against its whole shape):
    what the prefill and decode steps of a sharded model take."""
    whole = transformer.init_caches(cfg, batch, max_seq, dtype, "meta")
    specs = tree_lib.tree_map(lambda sh: sh.spec, sharding.tree_shardings(
        transformer.cache_logical_axes(cfg), tree_lib.tree_map(
            lambda a: tuple(a.shape), whole), mesh))
    caches = tree_lib.tree_map(
        lambda a, spec: torch.zeros(
            tuple(s.stop - s.start for s in sharding.shard_slices(
                tuple(a.shape), spec, mesh)), dtype=a.dtype, device=device),
        whole, specs)
    return caches, specs


def _check_mesh(model) -> None:
    """Raise unless a sharded model's step runs under its mesh (the
    caller's ``sharding.use_mesh``, which also holds the rules it was cut
    under)."""
    if model.shards is not None and \
            sharding.current_mesh() is not model.shards[0]:
        raise ValueError("a sharded model's step runs under its mesh: "
                         "call it inside sharding.use_mesh(mesh, rules)")


def make_prefill_step(cfg: transformer.ModelConfig, cache_specs=None):
    """``prefill_step(model, tokens, caches, extra=None)``: tokens [B, L]
    of one length, every slot from position 0, and a cross-attention
    model's encoder input ``extra`` → (the last position's logits [B, 1,
    vocab], caches). A sharded model (:func:`shard_model`) runs on this
    rank: ``tokens`` are its rows, ``caches`` its part (:func:`rank_caches`)
    and ``cache_specs`` their specs; the logits are the rank's rows, the
    whole vocabulary."""
    @torch.no_grad()
    def prefill_step(model, tokens, caches, extra=None):
        _check_dtype(cfg, model)
        _check_mesh(model)
        h = transformer.hidden(model, tokens, caches, 0, "prefill", extra,
                               cache_specs)
        return transformer.logits(model, h[:, -1:]), caches
    return prefill_step


def make_decode_step(cfg: transformer.ModelConfig, cache_specs=None):
    """``decode_step(model, tokens, caches, cache_pos)``: tokens [B, 1] at
    ``cache_pos``, the reference's scalar current length (an int or a 0-d
    tensor, every slot there) or a [B] tensor (slot b at its own) →
    (logits [B, 1, vocab], caches). A sharded model as in
    :func:`make_prefill_step` (a [B] ``cache_pos``: the rank's rows)."""
    @torch.no_grad()
    def decode_step(model, tokens, caches, cache_pos):
        _check_dtype(cfg, model)
        B = tokens.shape[0]
        if isinstance(cache_pos, torch.Tensor):
            pos = cache_pos.to(tokens.device)
            pos = pos.expand(B) if pos.dim() == 0 else pos
        else:   # a fill on the device: no copy from the host, no sync
            pos = torch.full((B,), int(cache_pos), dtype=torch.long,
                             device=tokens.device)
        _check_mesh(model)
        h = transformer.hidden(model, tokens, caches, pos, "decode", None,
                               cache_specs)
        return transformer.logits(model, h), caches
    return decode_step


@dataclasses.dataclass(frozen=True)
class AttentionCalls:
    """The calls of one attention kernel from one mixer kind's ``layers``
    in a prefill step and its decode steps. ``kernel`` is
    ``"flash_attention"``, one call a layer (q [B, H, L, hd] over k, v
    [B, H, Lk, hd]: the kv heads repeated ``group`` times, the repeats
    equal), or ``"flash_decode"``, one call a layer a decode step (q [B, H,
    hd] over caches [B, K, S, hd], every slot at that step's entry of
    ``lengths``)."""
    mixer: str
    kernel: str
    q: Tuple[int, ...]
    kv: Tuple[int, ...]
    group: int
    causal: bool
    window: Optional[int]
    lengths: Tuple[int, ...]
    layers: int

    @property
    def launches(self) -> int:
        return self.layers * (len(self.lengths)
                              if self.kernel == "flash_decode" else 1)


def attention_calls(cfg: transformer.ModelConfig, batch: int, prompt: int,
                    max_seq: int, n_new: int) -> List[AttentionCalls]:
    """The attention-kernel calls of ``make_prefill_step`` on ``batch``
    prompts of ``prompt`` tokens (a cross-attention model with its
    ``encoder_seq`` rows of encoder input) and ``n_new - 1``
    ``make_decode_step`` calls at the scalar positions ``prompt, prompt +
    1, ...``, over caches of ``max_seq`` rows: by mixer kind (the encoder's
    first), the prefill's kernel before the decode's. A ``shared`` site
    attends as a ``gqa`` layer does; a recurrent layer (models/ssm.py) or
    an MLA layer (plain PyTorch, as the reference's is plain ``jnp``) calls
    no attention kernel and is not listed."""
    B, H, K, hd = batch, cfg.n_heads, cfg.n_kv, cfg.hd
    G, S_enc = H // K, cfg.encoder_seq
    layers = Counter(transformer.parse_kind(kind)[0]
                     for groups in (cfg.encoder_groups, cfg.groups)
                     for pattern, count in groups
                     for kind in pattern for _ in range(count))
    steps = range(prompt, prompt + n_new - 1)
    out = []
    for mixer, n in layers.items():
        if mixer in ssm.RECURRENT or mixer == "mla":
            continue
        if mixer == "enc":
            out.append(AttentionCalls(mixer, "flash_attention",
                                      (B, H, S_enc, hd), (B, H, S_enc, hd),
                                      G, False, None, (), n))
            continue
        window = cfg.window_of(mixer)
        if mixer == "cross":
            Lk, S, lengths = S_enc, S_enc, (S_enc,) * len(steps)
        else:
            Lk = prompt
            S = min(max_seq, window) if window else max_seq
            lengths = tuple(min(p + 1, S) for p in steps)
        out.append(AttentionCalls(mixer, "flash_attention",
                                  (B, H, prompt, hd), (B, H, Lk, hd), G,
                                  mixer != "cross", window, (), n))
        out.append(AttentionCalls(mixer, "flash_decode", (B, H, hd),
                                  (B, K, S, hd), G, False, window, lengths,
                                  n))
    return out
