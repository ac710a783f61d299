"""Model configuration, weights and the dense forward pass.

Counterpart of ``repro/models/transformer.py``, limited to what the port
runs: groups of GQA layers, full-attention (``gqa``, ``global``) or
sliding-window (``local``, a ring of ``min(max_seq, window)`` cache rows),
and cross-attention layers (``cross``: llama-3.2-vision-11b, whisper's
decoder) over encoder states, with dense MLPs (swiglu, squared-ReLU or
whisper's GELU with biases) or a capacity-dispatched MoE (models/moe.py),
RMS norms (zero-centred scales and sandwich post-norms where the config
asks) or layer norms with biases, an optionally scaled embedding, learned
positions, whisper's encoder (``enc`` layers over stub frames,
:func:`encode`), and the recurrent mixers of models/ssm.py (``mamba``,
``mlstm``, ``slstm``: xlstm-1.3b, zamba2-1.2b) beside zamba2's
weight-shared attention block (``shared`` sites: one copy of an attention
mixer and MLP at the model's top level, ``shared_block``, with each site's
own norms and KV cache), and deepseek-v3's MLA layers (``mla``: a latent
cache, models/attention.py ``mla_forward``) with its multi-token
prediction head (``mtp``: drawn and held, read only by training).
:func:`forward` runs prefill and decode over dense slot caches
(:func:`init_caches`, models/attention.py) and, with ``mode="train"``,
the training forward (:func:`train_forward`: no caches, the reference's
``forward(mode="train")``); the paged steps
(serve/paged_step.py) walk the same layers with the same pieces
(:func:`embed`, :func:`layer_pre`, :func:`layer_post`, :func:`logits`)
over a page pool. On one rank of a mesh (``Transformer.shards``, set by
train/step.py ``shard_model``), :func:`hidden` runs each layer on the
rank's shards (:func:`_layers`: a unit's leaves gathered over the
batch axes when it is reached, FSDP's gather; the model axis
tensor-parallel in :func:`embed`, the attention layers
(``attention.gqa_forward``, ``cross_forward``, ``encoder_forward`` in
:func:`encode`, ``mla_forward``), the recurrent mixers (models/ssm.py
through :func:`recurrent_forward`), :func:`_ffn` and :func:`logits`, each
reading its leaves' specs); :func:`train_forward` runs the same layers on
the rank's shards under autograd (:func:`_train_layer`).
:class:`ModelConfig` keeps every field of the reference so that the
configs read the same, with torch dtypes in place of jnp ones
(``compute_dtype=torch.float32`` works as the reference override does).

Weights keep the reference layout: ``y = x @ w`` with ``w`` of shape
``[d_in, d_out]``, and each group's per-layer weights stacked along a
leading ``[count, ...]`` axis, so carrying reference weights across
(models/convert.py) is a copy, never a transpose. :class:`Transformer`
holds the reference's parameter tree leaf for leaf::

    {"embed": [vocab, d], "final_norm": {"scale": [d][, "bias": [d]]},
     "groups": [ (pos0, pos1, ...) per group ][, "lm_head": [d, vocab]]
     [, "pos_embed": [learned_pos, d]]
     [, "encoder": {"groups": [...], "final_norm": {...},
                    "pos_embed": [encoder_seq, d]}]
     [, "shared_block": {"mixer": {wq, wk, wv, wo}, "ffn": {...}}]
     [, "mtp": {"proj": [2d, d], "block": {one unstacked layer},
                "norm": {"scale": [d]}}]}

where each pattern position holds ``{"ln1": {"scale"[, "bias"]},
"mixer": {wq, wk, wv, wo[, bq, bk, bv]}, "ln2": {...}, "ffn": {w_gate,
w_up, w_down}}`` (a norm's ``bias`` under ``norm="layer"``; a ``cross``
mixer's ``wk`` / ``wv`` of fan-in ``cross_kv_dim`` and never a bias;
``{w_in, w_out}`` for ``mlp="relu2"``, ``{w_in, b_in, w_out, b_out}``
for ``mlp="gelu"``; ``{router, w_gate, w_up, w_down[, shared: {w_gate,
w_up, w_down}]}`` for a ``moe`` ffn, the experts on an ``[E, ...]``
axis; ``ln1_post`` / ``ln2_post`` beside them under ``sandwich_norm``)
with a leading ``count`` axis on every leaf. An ``mla`` layer's ``mixer``
holds ``attention.mla_leaves``; a recurrent layer's holds models/ssm.py's
leaves and it has no ``ln2`` / ``ffn``; a ``shared``
site holds only its norms ``ln1`` / ``ln2``, its mixer and MLP being the
unstacked ``shared_block``'s (:func:`units` hands them over).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tree as tree_lib
from repro_torch.models import attention, blocks, ssm
from repro_torch.models import moe as moe_lib
from repro_torch.parallel import sharding

Pattern = Tuple[str, ...]
Group = Tuple[Pattern, int]

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    groups: Tuple[Group, ...]
    head_dim: Optional[int] = None
    mlp: str = "swiglu"              # swiglu | gelu | relu2
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    window: Optional[int] = None
    logit_softcap: Optional[float] = None
    norm: str = "rms"                # rms | layer
    zero_centered_norm: bool = False
    sandwich_norm: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = False
    learned_pos: Optional[int] = None  # whisper: learned positional embed size
    moe: Optional[moe_lib.MoeConfig] = None
    mla: Optional[attention.MlaConfig] = None
    mamba: Optional[ssm.Mamba2Config] = None
    mlstm: Optional[ssm.MlstmConfig] = None
    slstm: Optional[ssm.SlstmConfig] = None
    # encoder (whisper) / cross-kv (vlm) stubs
    encoder_groups: Tuple[Group, ...] = ()
    encoder_seq: int = 0             # stub frontend sequence length
    cross_kv_dim: Optional[int] = None
    mtp: bool = False                # deepseek multi-token prediction head
    # compute policy
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "none"
    q_chunk: int = 1024
    kv_chunk: int = 1024
    shard_kv_seq: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_layers(self) -> int:
        return sum(len(p) * c for p, c in self.groups) + \
            sum(len(p) * c for p, c in self.encoder_groups)

    def window_of(self, mixer: str) -> Optional[int]:
        """The reference's per-kind window (``attn_cfg(kind)``): the
        config's sliding window for ``local`` layers, none for others."""
        return self.window if mixer == "local" else None


def parse_kind(kind: str) -> Tuple[str, str]:
    mixer, _, ffn = kind.partition(":")
    return mixer, ffn or "mlp"


def couples_rows(cfg: ModelConfig) -> bool:
    """True when a layer's ffn is a MoE: the rows of one call then share
    expert capacity, so a row's output depends on the others."""
    return any(parse_kind(kind)[1] == "moe"
               for pattern, _ in cfg.groups for kind in pattern)


def has_cross(cfg: ModelConfig) -> bool:
    """True when a layer cross-attends encoder states (``extra``)."""
    return any(parse_kind(kind)[0] == "cross"
               for pattern, _ in cfg.groups for kind in pattern)


def has_shared(cfg: ModelConfig) -> bool:
    """True when a layer is a site of the weight-shared block (zamba2)."""
    return any(parse_kind(kind)[0] == "shared"
               for pattern, _ in cfg.groups for kind in pattern)


DECODER_MIXERS = ("gqa", "global", "local", "cross", "shared", "mla") + \
    ssm.RECURRENT


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is on this port's path: full-attention,
    sliding-window, cross-attention, weight-shared or latent (``mla``, with
    ``cfg.mla`` set) attention mixers (``enc`` ones in the encoder alone)
    with dense swiglu, squared-ReLU or GELU MLPs or a MoE (with ``cfg.moe``
    set), or a recurrent mixer (``mamba`` / ``mlstm`` / ``slstm`` with its
    config set) with no ffn; a ``shared`` site with an MLP; RMS or layer
    norms. Every mixer and ffn of the reference's zoo is here,
    for serving and for the training forward alike."""
    for groups, mixers in ((cfg.groups, DECODER_MIXERS),
                           (cfg.encoder_groups, ("enc",))):
        for pattern, _ in groups:
            for kind in pattern:
                mixer, ffn = parse_kind(kind)
                if mixer not in mixers:
                    raise NotImplementedError(
                        f"repro_torch: mixer {mixer!r} is not ported yet "
                        "(ROADMAP queue 1, item 16)")
                if mixer == "mla" and cfg.mla is None:
                    raise NotImplementedError(
                        f"repro_torch: an 'mla' layer needs cfg.mla (got "
                        f"{kind!r})")
                if ffn not in ("mlp", "none") and not (
                        ffn == "moe" and cfg.moe is not None):
                    raise NotImplementedError(
                        f"repro_torch: ffn {ffn!r} is not ported yet "
                        "(ROADMAP queue 1, item 16)")
                if mixer in ssm.RECURRENT and (
                        ffn != "none" or getattr(cfg, mixer) is None):
                    raise NotImplementedError(
                        f"repro_torch: a {mixer!r} layer takes no ffn and "
                        f"needs cfg.{mixer} (got {kind!r})")
                if mixer == "shared" and ffn != "mlp":
                    raise NotImplementedError(
                        f"repro_torch: a shared site carries the shared "
                        f"MLP (got {kind!r})")
    if cfg.mlp not in ("swiglu", "relu2", "gelu") or \
            cfg.norm not in ("rms", "layer"):
        raise NotImplementedError(
            f"repro_torch: {cfg.name} needs blocks not ported yet "
            "(ROADMAP queue 1, item 4 and 16)")
    if has_cross(cfg) and cfg.encoder_seq <= 0:
        raise ValueError(f"{cfg.name}: cross-attention layers need "
                         "encoder_seq > 0 (the cross cache's rows)")


# --------------------------------------------------------------------------
# init: same distributions as the reference (not the same numbers)
# --------------------------------------------------------------------------
DRAW_ELEMS = 2**28    # most elements of a 2-D leaf drawn in one f32 piece


def _piece_index(shape: Tuple[int, ...]):
    """The indices of the pieces :func:`_normal` draws a ``shape`` leaf in,
    in order: a leaf of more than two axes one slice of its first axis at
    a time, each slice of more than ``DRAW_ELEMS`` elements split again
    the same way; a 2-D one in runs of whole rows of at most
    ``DRAW_ELEMS`` elements."""
    if len(shape) > 2:
        sub = shape[1:]
        inner = _piece_index(sub) if math.prod(sub) > DRAW_ELEMS else \
            ((slice(None),) * len(sub),)
        return [(i,) + rest for i in range(shape[0]) for rest in inner]
    if len(shape) == 2:
        step = max(1, DRAW_ELEMS // max(1, shape[1]))
        return [(slice(r, min(r + step, shape[0])), slice(None))
                for r in range(0, shape[0], step)]
    return [(slice(None),) * len(shape)]


def _pieces(t: torch.Tensor):
    """The views :func:`_normal` draws ``t`` in, in order
    (:func:`_piece_index`)."""
    return [t[idx] for idx in _piece_index(tuple(t.shape))]


def _normal(shape, std: float, generator, device, dtype, part=None):
    """N(0, std²) at ``dtype``, drawn in f32 one ``[count]`` slice of a
    stacked leaf at a time: a whole f32 draw of yi-34b's ``[60, 7168,
    20480]`` MLP leaves would need a 35 GB temporary beside the weights.
    A slice or a 2-D leaf of more than ``DRAW_ELEMS`` elements is drawn in
    smaller pieces (:func:`_pieces`): gemma3-27b's ``[262144, 5376]``
    embedding whole would be a 5.6 GB temporary, one layer of
    deepseek-v3's ``[256, 7168, 2048]`` experts 15 GB. ``part``: the
    slices of the leaf to make (None: all of it); every piece is drawn
    and the part keeps what falls in it, so its values are the whole
    draw's."""
    shape = tuple(shape)
    part = part or tuple(slice(0, n) for n in shape)
    out = torch.empty(tuple(p.stop - p.start for p in part), dtype=dtype,
                      device=device)
    if out.device.type == "meta":
        return out
    for idx in _piece_index(shape):
        piece = [(i, i + 1) if isinstance(i, int) else
                 (i.start or 0, n if i.stop is None else i.stop)
                 for i, n in zip(idx, shape)]
        w = torch.empty(tuple(hi - lo for lo, hi in piece),
                        dtype=torch.float32, device=device)
        w.normal_(0.0, 1.0, generator=generator).mul_(std)
        cut = [(max(lo, p.start), min(hi, p.stop))
               for (lo, hi), p in zip(piece, part)]
        if all(lo < hi for lo, hi in cut):
            out[tuple(slice(lo - p.start, hi - p.start) for (lo, hi), p in
                      zip(cut, part))].copy_(w[tuple(
                          slice(lo - a, hi - a) for (lo, hi), (a, _) in
                          zip(cut, piece))])
    return out


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None, part=None) -> "Transformer":
    """Random weights drawn from the reference's distributions
    (``transformer.py:113-246`` and ``attention.init_gqa`` /
    ``init_cross``): dense weights N(0, 1/fan_in) (a cross layer's ``wk``
    / ``wv`` of fan-in ``cross_kv_dim``), ``wo`` N(0, 1/(H·hd)), the
    embedding N(0, 0.02²), learned positions (``pos_embed``, the
    encoder's too) N(0, 0.02²), norm scales 1 (0 when zero-centred: the
    norm multiplies by 1 + scale) and layer-norm biases 0, sandwich
    post-norms beside them, QKV and GELU biases 0, a MoE's leaves as
    ``moe.leaf_shapes`` says (the router f32 whatever ``param_dtype``), a
    recurrent layer's as ``ssm.LEAVES`` says (the mLSTM's ``w_if`` f32),
    an ``mla`` layer's as ``attention.mla_leaves`` says, the unstacked
    ``shared_block`` (an attention mixer and an MLP) when a layer is a
    ``shared`` site, and under ``cfg.mtp`` the multi-token prediction head
    ``mtp``: ``proj`` [2d, d] N(0, 1/(2d)), one unstacked layer of the last
    kind (``block``) and a norm. Leaves are made at
    ``cfg.param_dtype`` (a full-width model at bf16 passes
    ``param_dtype=torch.bfloat16``, so the executor's cast to the compute
    dtype copies nothing). ``generator`` must live on ``device`` (a
    ``meta`` device allocates nothing, for counting parameters).
    ``part(path)``: the slices of the leaf at ``path`` (its keys in
    :func:`param_tree`) to make, or None for the whole leaf; each leaf is
    then made at that part's shape alone, with the values the whole draw
    gives it (train/step.py ``init_shards``: a rank's shards with no whole
    leaf on the device)."""
    check_supported(cfg)
    device = torch.device(device if device is not None else "cpu")
    dt = cfg.param_dtype
    d, f, H, K, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv, cfg.hd
    keep = part or (lambda path: None)

    def normal(path, shape, std, dtype=dt):
        return _normal(shape, std, generator, device, dtype, keep(path))

    def made(path, whole):
        """A leaf computed whole (a constant, small), cut to its part."""
        sl = keep(path)
        return whole if sl is None else whole[sl].clone()

    def full(path, shape, value):
        return made(path, torch.full(shape, value, dtype=dt, device=device))

    def norm(path, shape):
        if cfg.norm == "layer":
            return {"scale": full(path + ("scale",), shape, 1.0),
                    "bias": full(path + ("bias",), shape, 0.0)}
        return {"scale": full(path + ("scale",), shape,
                              0.0 if cfg.zero_centered_norm else 1.0)}

    def mixer_tree(mixer, lead, path):
        """An attention mixer's leaves, each with the leading axes
        ``lead`` (``(count,)`` in a group, ``()`` in the shared block or
        the MTP head)."""
        if mixer == "mla":
            return {name: full(path + (name,), lead + shape, 1.0)
                    if std is None else normal(path + (name,), lead + shape,
                                               std)
                    for name, (shape, std) in
                    attention.mla_leaves(cfg.mla).items()}
        kvd = (cfg.cross_kv_dim or d) if mixer == "cross" else d
        out = {"wq": normal(path + ("wq",), lead + (d, H * hd),
                            1 / math.sqrt(d)),
               "wk": normal(path + ("wk",), lead + (kvd, K * hd),
                            1 / math.sqrt(kvd)),
               "wv": normal(path + ("wv",), lead + (kvd, K * hd),
                            1 / math.sqrt(kvd)),
               "wo": normal(path + ("wo",), lead + (H * hd, d),
                            1 / math.sqrt(H * hd))}
        if cfg.qkv_bias and mixer != "cross":
            for b, n in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
                out[b] = full(path + (b,), lead + (n,), 0.0)
        return out

    def recurrent_tree(mixer, lead, path):
        out = {}
        for name, (shape, init) in ssm.LEAVES[mixer](
                getattr(cfg, mixer)).items():
            shape, at = lead + shape, path + (name,)
            if init == ssm.ONES:
                out[name] = full(at, shape, 1.0)
            elif init == ssm.ZEROS:
                out[name] = full(at, shape, 0.0)
            elif init == ssm.A_LOG:
                a = torch.linspace(1.0, 16.0, shape[-1], device=device)
                out[name] = made(at, torch.log(a).to(dt).expand(shape).clone())
            else:
                out[name] = normal(at, shape, init,
                                   torch.float32 if name in ssm.F32_LEAVES
                                   else dt)
        return out

    def mlp_tree(lead, path):
        at = lambda name: path + (name,)    # noqa: E731
        if cfg.mlp == "relu2":
            return {"w_in": normal(at("w_in"), lead + (d, f),
                                   1 / math.sqrt(d)),
                    "w_out": normal(at("w_out"), lead + (f, d),
                                    1 / math.sqrt(f))}
        if cfg.mlp == "gelu":
            return {"w_in": normal(at("w_in"), lead + (d, f),
                                   1 / math.sqrt(d)),
                    "b_in": full(at("b_in"), lead + (f,), 0.0),
                    "w_out": normal(at("w_out"), lead + (f, d),
                                    1 / math.sqrt(f)),
                    "b_out": full(at("b_out"), lead + (d,), 0.0)}
        return {"w_gate": normal(at("w_gate"), lead + (d, f),
                                 1 / math.sqrt(d)),
                "w_up": normal(at("w_up"), lead + (d, f), 1 / math.sqrt(d)),
                "w_down": normal(at("w_down"), lead + (f, d),
                                 1 / math.sqrt(f))}

    def moe_tree(lead, path):
        out: Dict[str, Any] = {}
        for name, shape in moe_lib.leaf_shapes(cfg.moe).items():
            w = normal(path + tuple(name.split(".")), lead + shape,
                       1 / math.sqrt(shape[0]),
                       torch.float32 if name == "router" else dt)
            head, _, leaf = name.rpartition(".")
            (out.setdefault(head, {}) if head else out)[leaf] = w
        return out

    def layer_tree(kind, lead, path):
        """One layer's leaves, each with the leading axes ``lead``."""
        mixer, ffn = parse_kind(kind)
        layer = {"ln1": norm(path + ("ln1",), lead + (d,))}
        if mixer in ssm.RECURRENT:
            layer["mixer"] = recurrent_tree(mixer, lead, path + ("mixer",))
        elif mixer != "shared":   # a site's weights: shared_block
            layer["mixer"] = mixer_tree(mixer, lead, path + ("mixer",))
        if ffn != "none":
            layer["ln2"] = norm(path + ("ln2",), lead + (d,))
        if ffn != "none" and mixer != "shared":
            layer["ffn"] = (moe_tree if ffn == "moe" else mlp_tree)(
                lead, path + ("ffn",))
        if cfg.sandwich_norm:
            layer["ln1_post"] = norm(path + ("ln1_post",), lead + (d,))
            if ffn != "none":
                layer["ln2_post"] = norm(path + ("ln2_post",), lead + (d,))
        return layer

    def groups_tree(groups, path):
        return [tuple(layer_tree(kind, (count,), path + (gi, i))
                      for i, kind in enumerate(pattern))
                for gi, (pattern, count) in enumerate(groups)]

    params: Dict[str, Any] = {"groups": groups_tree(cfg.groups, ("groups",))}
    params["embed"] = normal(("embed",), (cfg.vocab, d), 0.02)
    params["final_norm"] = norm(("final_norm",), (d,))
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(("lm_head",), (d, cfg.vocab),
                                   1 / math.sqrt(d))
    if cfg.learned_pos:
        params["pos_embed"] = normal(("pos_embed",), (cfg.learned_pos, d),
                                     0.02)
    if cfg.encoder_groups:
        enc = ("encoder",)
        params["encoder"] = {
            "groups": groups_tree(cfg.encoder_groups, enc + ("groups",)),
            "final_norm": norm(enc + ("final_norm",), (d,)),
            "pos_embed": normal(enc + ("pos_embed",), (cfg.encoder_seq, d),
                                0.02)}
    if has_shared(cfg):
        params["shared_block"] = {
            "mixer": mixer_tree("shared", (), ("shared_block", "mixer")),
            "ffn": mlp_tree((), ("shared_block", "ffn"))}
    if cfg.mtp:
        params["mtp"] = {"proj": normal(("mtp", "proj"), (2 * d, d),
                                        1 / math.sqrt(2 * d)),
                         "block": layer_tree(cfg.groups[-1][0][-1], (),
                                             ("mtp", "block")),
                         "norm": norm(("mtp", "norm"), (d,))}
    return Transformer(cfg, params)


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical sharding axes of every leaf of :func:`init_model`'s
    tree, keyed as :func:`param_tree` keys the leaves: the second tree the
    reference's ``blocks.split_params(init_model(...))`` returns. A leaf's
    axes are a tuple, one entry (None or a logical name,
    parallel/sharding.py ``DEFAULT_RULES``) a dimension; a group's
    stacked leaves lead with ``layers`` (``sharding.stack_axes``), a MoE's
    experts take ``moe.leaf_axes`` by ``cfg.moe.ep``."""
    check_supported(cfg)
    norm = {"scale": (None,)}
    if cfg.norm == "layer":
        norm["bias"] = (None,)
    proj_in, proj_out = ("embed_fsdp", "heads_tp"), ("heads_tp", "embed_fsdp")

    def mixer_axes(mixer):
        if mixer == "mla":
            return dict(attention.MLA_AXES)
        out = {"wq": proj_in, "wk": proj_in, "wv": proj_in, "wo": proj_out}
        if cfg.qkv_bias and mixer != "cross":
            out.update(bq=("heads_tp",), bk=("heads_tp",), bv=("heads_tp",))
        return out

    def mlp_axes():
        up, down = ("embed_fsdp", "mlp_tp"), ("mlp_tp", "embed_fsdp")
        if cfg.mlp == "relu2":
            return {"w_in": up, "w_out": down}
        if cfg.mlp == "gelu":
            return {"w_in": up, "b_in": ("mlp_tp",), "w_out": down,
                    "b_out": (None,)}
        return {"w_gate": up, "w_up": up, "w_down": down}

    def moe_axes():
        out: Dict[str, Any] = {}
        for name, axes in moe_lib.leaf_axes(cfg.moe).items():
            head, _, leaf = name.rpartition(".")
            (out.setdefault(head, {}) if head else out)[leaf] = axes
        return out

    def layer_axes(kind):
        mixer, ffn = parse_kind(kind)
        layer: Dict[str, Any] = {"ln1": dict(norm)}
        if mixer in ssm.RECURRENT:
            layer["mixer"] = dict(ssm.AXES[mixer])
        elif mixer != "shared":
            layer["mixer"] = mixer_axes(mixer)
        if ffn != "none":
            layer["ln2"] = dict(norm)
        if ffn != "none" and mixer != "shared":
            layer["ffn"] = moe_axes() if ffn == "moe" else mlp_axes()
        if cfg.sandwich_norm:
            layer["ln1_post"] = dict(norm)
            if ffn != "none":
                layer["ln2_post"] = dict(norm)
        return layer

    def groups_axes(groups):
        return [tuple(tree_lib.tree_map(sharding.stack_axes, layer_axes(kind),
                                        is_leaf=sharding.is_spec)
                      for kind in pattern) for pattern, _ in groups]

    out: Dict[str, Any] = {"groups": groups_axes(cfg.groups),
                           "embed": ("vocab_tp", None),
                           "final_norm": dict(norm)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed_fsdp", "vocab_tp")
    if cfg.learned_pos:
        out["pos_embed"] = (None, "embed_fsdp")
    if cfg.encoder_groups:
        out["encoder"] = {"groups": groups_axes(cfg.encoder_groups),
                          "final_norm": dict(norm),
                          "pos_embed": (None, "embed_fsdp")}
    if has_shared(cfg):
        out["shared_block"] = {"mixer": mixer_axes("shared"),
                               "ffn": mlp_axes()}
    if cfg.mtp:
        out["mtp"] = {"proj": (None, "embed_fsdp"),
                      "block": layer_axes(cfg.groups[-1][0][-1]),
                      "norm": dict(norm)}
    return out


def count_params(model: "Transformer") -> int:
    return sum(p.numel() for p in model.parameters())


# --------------------------------------------------------------------------
# the module: the reference's parameter tree, leaf for leaf
# --------------------------------------------------------------------------
class LayerStack(nn.Module):
    """One pattern position of a group: ``count`` layers' weights stacked
    along axis 0, named as in the reference tree (``ln1``, ``mixer.*``,
    ``ln2``, ``ffn.*``, and the sandwich post-norms ``ln1_post`` /
    ``ln2_post`` where the tree has them). A norm's scale sits under its
    name and a layer norm's bias beside it as ``<name>_bias``. A MoE's
    shared experts (``ffn.shared.*`` in the tree) sit in ``ffn_shared``.
    A ``shared`` site has no ``mixer`` / ``ffn`` of its own (None here).
    ``unit(u)`` gives layer ``u``'s views."""
    POST = ("ln1_post", "ln2_post")

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        _set_norm(self, "ln1", tree["ln1"])
        self.mixer = nn.ParameterDict(
            {k: _leaf(v) for k, v in tree["mixer"].items()}) \
            if "mixer" in tree else None
        self.has_ln2 = "ln2" in tree
        if self.has_ln2:
            _set_norm(self, "ln2", tree["ln2"])
        self.has_ffn = "ffn" in tree
        if self.has_ffn:
            ffn = dict(tree["ffn"])
            shared = ffn.pop("shared", None)
            self.ffn = nn.ParameterDict(
                {k: _leaf(v) for k, v in ffn.items()})
            self.ffn_shared = None if shared is None else nn.ParameterDict(
                {k: _leaf(v) for k, v in shared.items()})
        self.post = tuple(n for n in self.POST if n in tree)
        for name in self.post:
            _set_norm(self, name, tree[name])

    @property
    def count(self) -> int:
        return self.ln1.shape[0]

    def tree(self) -> Dict[str, Any]:
        """The position's leaves in the reference's layout (stacked, or the
        MTP head's unstacked block)."""
        out = {"ln1": _norm_leaf(self, "ln1")}
        if self.mixer is not None:
            out["mixer"] = dict(self.mixer)
        if self.has_ln2:
            out["ln2"] = _norm_leaf(self, "ln2")
        if self.has_ffn:
            out["ffn"] = dict(self.ffn)
            if self.ffn_shared is not None:
                out["ffn"]["shared"] = dict(self.ffn_shared)
        for name in self.post:
            out[name] = _norm_leaf(self, name)
        return out

    def unit(self, u: int) -> Dict[str, Any]:
        out = {"ln1": _norm_leaf(self, "ln1", u)}
        if self.mixer is not None:
            out["mixer"] = {k: v[u] for k, v in self.mixer.items()}
        if self.has_ln2:
            out["ln2"] = _norm_leaf(self, "ln2", u)
        if self.has_ffn:
            out["ffn"] = {k: v[u] for k, v in self.ffn.items()}
            if self.ffn_shared is not None:
                out["ffn"]["shared"] = {k: v[u] for k, v in
                                        self.ffn_shared.items()}
        for name in self.post:
            out[name] = _norm_leaf(self, name, u)
        return out


def _set_norm(mod: nn.Module, name: str, leaf: Dict[str, Any]) -> None:
    """A norm leaf onto ``mod``: its scale as ``<name>``, a layer norm's
    bias as ``<name>_bias`` (None without one)."""
    setattr(mod, name, _leaf(leaf["scale"]))
    setattr(mod, name + "_bias",
            _leaf(leaf["bias"]) if "bias" in leaf else None)


def _norm_leaf(mod: nn.Module, name: str, u: Optional[int] = None):
    """The reference's norm leaf ``{"scale"[, "bias"]}`` from ``mod`` (the
    rows of layer ``u`` of a stack when given)."""
    out = {"scale": getattr(mod, name), "bias": getattr(mod, name + "_bias")}
    return {k: v if u is None else v[u] for k, v in out.items()
            if v is not None}


def _stacks(groups) -> nn.ModuleList:
    return nn.ModuleList(nn.ModuleList(LayerStack(pos) for pos in group)
                         for group in groups)


class Encoder(nn.Module):
    """Whisper's encoder: its ``groups`` of ``enc`` layers, ``final_norm``
    and learned ``pos_embed`` [encoder_seq, d] (the reference's
    ``params["encoder"]``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.groups = _stacks(tree["groups"])
        _set_norm(self, "final_norm", tree["final_norm"])
        self.pos_embed = _leaf(tree["pos_embed"])


class SharedBlock(nn.Module):
    """zamba2's weight-shared block (the reference's
    ``params["shared_block"]``): one attention ``mixer`` and one MLP
    ``ffn``, unstacked, that every ``shared`` site runs."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.mixer = nn.ParameterDict(
            {k: _leaf(v) for k, v in tree["mixer"].items()})
        self.ffn = nn.ParameterDict(
            {k: _leaf(v) for k, v in tree["ffn"].items()})


class MtpHead(nn.Module):
    """deepseek-v3's multi-token prediction head (the reference's
    ``params["mtp"]``): ``proj`` [2d, d], one unstacked ``block`` of the
    model's last layer kind, and ``norm``. Only the training forward reads
    it (:func:`train_forward` with ``next_tokens``); serving holds it and
    never does."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.proj = _leaf(tree["proj"])
        self.block = LayerStack(tree["block"])
        _set_norm(self, "norm", tree["norm"])


class Transformer(nn.Module):
    """The model's weights (``embed``, ``final_norm``, ``groups``, optional
    ``lm_head``, ``pos_embed``, ``encoder``, ``shared_block`` and ``mtp``)
    in the reference layout (:func:`param_tree` gives them as the
    reference's tree); the forward passes and the paged steps
    (serve/paged_step.py) are plain functions over it. Weights are made
    without gradients, as serving wants them; training turns them on with
    ``model.requires_grad_(True)`` (train/step.py ``init_state``).
    ``shards``: None, or once train/step.py ``shard_model`` has cut every
    leaf to this rank's shard, ``(mesh, specs)`` with ``specs`` the
    :func:`param_tree`-shaped tree of each leaf's spec
    (:func:`train_forward` gathers each leaf where it is used; the
    serving forward gathers the batch axes and runs the rest
    tensor-parallel, :func:`hidden`)."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _leaf(tree["embed"])
        _set_norm(self, "final_norm", tree["final_norm"])
        self.groups = _stacks(tree["groups"])
        self.lm_head = (_leaf(tree["lm_head"]) if "lm_head" in tree
                        else None)
        self.pos_embed = (_leaf(tree["pos_embed"]) if "pos_embed" in tree
                          else None)
        self.encoder = (Encoder(tree["encoder"]) if "encoder" in tree
                        else None)
        self.shared_block = (SharedBlock(tree["shared_block"])
                             if "shared_block" in tree else None)
        self.mtp = MtpHead(tree["mtp"]) if "mtp" in tree else None
        self.shards = None    # (mesh, specs) once train/step.py shards it
        if bool(cfg.learned_pos) != (self.pos_embed is not None) or \
                bool(cfg.encoder_groups) != (self.encoder is not None) or \
                has_shared(cfg) != (self.shared_block is not None) or \
                cfg.mtp != (self.mtp is not None):
            raise ValueError(f"{cfg.name}: pos_embed / encoder / "
                             "shared_block / mtp leaves do not match the "
                             "config's learned_pos / encoder_groups / shared "
                             "sites / mtp")

    def head(self) -> torch.Tensor:
        """[d, vocab]: the tied embedding's transpose or the LM head."""
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


def _leaf(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def param_tree(model: Transformer) -> Dict[str, Any]:
    """The module's parameters (the tensors themselves, no copy) as the
    reference's tree: ``embed``, ``final_norm``, ``groups`` (a list of
    tuples, one entry a pattern position), and ``lm_head``,
    ``pos_embed``, ``encoder``, ``shared_block`` and ``mtp`` where the
    model has them (models/convert.py, train/step.py, checkpoints)."""
    def groups(stacks):
        return [tuple(pos.tree() for pos in group) for group in stacks]

    out: Dict[str, Any] = {"embed": model.embed,
                           "final_norm": _norm_leaf(model, "final_norm"),
                           "groups": groups(model.groups)}
    if model.lm_head is not None:
        out["lm_head"] = model.lm_head
    if model.pos_embed is not None:
        out["pos_embed"] = model.pos_embed
    if model.encoder is not None:
        enc = model.encoder
        out["encoder"] = {"groups": groups(enc.groups),
                          "final_norm": _norm_leaf(enc, "final_norm"),
                          "pos_embed": enc.pos_embed}
    if model.shared_block is not None:
        out["shared_block"] = {"mixer": dict(model.shared_block.mixer),
                               "ffn": dict(model.shared_block.ffn)}
    if model.mtp is not None:
        out["mtp"] = {"proj": model.mtp.proj, "block": model.mtp.block.tree(),
                      "norm": _norm_leaf(model.mtp, "norm")}
    return out


# --------------------------------------------------------------------------
# layer pieces: the dense forward below and serve/paged_step.py
# --------------------------------------------------------------------------
def _norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layer":
        return blocks.layer_norm(p["scale"], p["bias"], x)
    return blocks.rms_norm(p["scale"], x, zero_centered=cfg.zero_centered_norm)


MLP_LEAVES = {"swiglu": (("w_gate", "w_up"), "w_down"),   # (column-,
              "relu2": (("w_in",), "w_out"),             # row-parallel)
              "gelu": (("w_in", "b_in"), "w_out")}
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")   # a MoE's [E, ...] leaves


def _ffn(p, ffn: str, x: torch.Tensor, cfg: ModelConfig, spec=None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, the MoE's aux · aux_weight, None for an MLP).

    On one rank of the active mesh, ``p`` holds the rank's shards and
    ``spec`` their specs once the batch axes are gathered (x is the
    rank's rows, whole; so is y). An MLP is column-parallel in
    (:data:`MLP_LEAVES`: the rank's columns of the hidden) and
    row-parallel out, then summed over the out leaf's line, then
    ``b_out``; where the in leaves' columns are not the out leaf's rows
    (a binding that ``resolve`` dropped for one of them) the in leaves
    are cut to those rows first, gathered over their line where they do
    not hold them. Under autograd x enters through ``copy_to`` over the
    out leaf's line and an in leaf whole on it too (a rank uses its rows
    alone, so the gradient is summed over the line); a gathered in leaf
    takes ``take(..., apart=True)``. A MoE's leaves are made whole over
    every axis but a held expert axis (the reference's ``shard_map``
    takes the experts whole, or their EP shard), with ``gather_from``:
    ``moe_forward``'s mesh paths sum the ranks' shares of them itself."""
    mesh = sharding.current_mesh()
    if ffn == "moe":
        if spec is not None:
            p = {k: sharding.gather_tree(
                v, (None,) + spec[k][1:] if k in EXPERT_LEAVES else spec[k],
                mesh, alike=True) for k, v in p.items()}
        return moe_lib.moe_forward(p, x, cfg.moe)
    if ffn != "mlp" or cfg.mlp not in MLP_LEAVES:
        raise NotImplementedError(f"repro_torch: ffn {ffn!r}/{cfg.mlp!r}")
    spec = spec or {}
    ins, out = MLP_LEAVES[cfg.mlp]
    rows = sharding.held(p[out], spec.get(out), 0, mesh)
    p = dict(p)
    if rows.line is not None:
        x = sharding.copy_to(x, rows.line)
    for k in ins:
        cols = sharding.held(p[k], spec.get(k), p[k].dim() - 1, mesh)
        if (cols.lo, cols.hi) != (rows.lo, rows.hi):
            if cols.line is None:
                p[k] = sharding.copy_to(p[k], rows.line)
            p[k] = sharding.take(p[k], cols, (rows.lo, rows.hi),
                                 apart=rows.line is not None)[0]
    if cfg.mlp == "swiglu":
        y = blocks.swiglu(p["w_gate"], p["w_up"], p["w_down"], x)
    elif cfg.mlp == "relu2":
        y = blocks.relu2_mlp(p["w_in"], p["w_out"], x)
    else:
        y = blocks.gelu_mlp(p["w_in"], p["b_in"], p["w_out"],
                            p["b_out"] if rows.line is None else None, x)
    if rows.line is None:
        return y, None
    y = sharding.reduce_from(y, rows.line)
    return (y + p["b_out"] if cfg.mlp == "gelu" else y), None


def _ffn_apply(p, ffn: str, x: torch.Tensor, cfg: ModelConfig,
               spec=None) -> torch.Tensor:
    """y alone: serving drops the MoE's aux, as the reference's serving
    steps do."""
    return _ffn(p, ffn, x, cfg, spec)[0]


def _layers(model: Transformer, caches, cache_specs=None):
    """Walk every layer in order: (kind, layer weights, their specs, that
    layer's views of ``caches``, their specs). Cache leaves carry a
    leading ``[count]`` axis per group position (dense slot caches from
    :func:`init_caches`, or page pools); a layer's view drops it. A
    ``shared`` site's weights are its own norms with the shared block's
    ``mixer`` and ``ffn``. On one rank of a mesh (``model.shards``) each
    unit's leaves are gathered over the batch axes when it is reached,
    never the whole model at once (:func:`_rank_tree`); the specs are
    None without a mesh."""
    shared = model.shared_block
    if shared is not None:
        shared = _rank_tree(model, {"mixer": dict(shared.mixer),
                                    "ffn": dict(shared.ffn)}, "shared_block")
    for gi, (pattern, count) in enumerate(model.cfg.groups):
        for u in range(count):
            for i, kind in enumerate(pattern):
                p, ps = _rank_tree(model, model.groups[gi][i].unit(u),
                                   "groups", gi, i, unit=True)
                if parse_kind(kind)[0] == "shared":
                    p = dict(p, mixer=dict(shared[0]["mixer"]),
                             ffn=dict(shared[0]["ffn"]))
                    ps = ps if ps is None else dict(ps, **shared[1])
                yield (kind, p, ps,
                       {name: arr[u] for name, arr in caches[gi][i].items()},
                       None if cache_specs is None else
                       _spec_at(cache_specs, (gi, i), True))


def units(model: Transformer, caches):
    """Walk every layer in order: (kind, layer weights, that layer's views
    of ``caches``), as :func:`_layers`."""
    for kind, p, _, cache, _ in _layers(model, caches):
        yield kind, p, cache


def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """√d_model rounded to ``dtype`` first, as the reference's
    ``jnp.asarray(sqrt(d), compute_dtype)``: in bf16 √5376 = 73.32 is
    73.5."""
    return blocks.rounded(math.sqrt(d_model), dtype)


def _lookup(table: torch.Tensor, spec, tokens: torch.Tensor
            ) -> torch.Tensor:
    """The rows of ``tokens`` from ``table``, which holds the rows
    :func:`sharding.held` gives it under ``spec``: where they are cut over
    a line (``vocab_tp``), the tokens in the rank's row range looked up
    through ``legalized_take``, the rest zero, summed over the line
    (exact: one rank holds each row; the backward passes each rank the
    whole cotangent, of which its rows take their tokens')."""
    rows = sharding.held(table, spec, 0, sharding.current_mesh())
    if rows.line is None:
        return blocks.embed_lookup(table, tokens)
    local = tokens.long() - rows.lo
    inside = (local >= 0) & (local < table.shape[0])
    x = blocks.embed_lookup(table, local.clamp(0, table.shape[0] - 1))
    return sharding.reduce_from(
        torch.where(inside[..., None], x, torch.zeros_like(x)), rows.line)


def embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (scaled where the config says).
    On a rank (``model.shards``) whose table is cut over its vocabulary
    (``vocab_tp``): :func:`_lookup`."""
    x = _lookup(*_rank_tree(model, model.embed, "embed"), tokens)
    if model.cfg.embed_scale:
        x = x * embed_scale(model.cfg.d_model, x.dtype)
    return x


def logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head. On a rank whose head is cut over the
    vocabulary (the tied embedding's rows, or ``lm_head``'s columns):
    the rank's logits, all-gathered over the line into the whole
    vocabulary."""
    h = _norm_apply(_norm_leaf(model, "final_norm"), x, model.cfg)
    mesh = sharding.current_mesh()
    if model.cfg.tie_embeddings:
        table, spec = _rank_tree(model, model.embed, "embed")
        head, cols = table.t(), sharding.held(table, spec, 0, mesh)
    else:
        head, spec = _rank_tree(model, model.lm_head, "lm_head")
        cols = sharding.held(head, spec, 1, mesh)
    out = h @ head
    return out if cols.line is None else \
        sharding.gather_from(out, cols.line, -1)


# --------------------------------------------------------------------------
# one rank of a mesh: the leaves the serving forward takes
# --------------------------------------------------------------------------
def _rank_tree(model: Transformer, tree, *path, unit: bool = False):
    """(``tree``, None) without a mesh. On one rank (``model.shards``):
    ``tree`` (this rank's shards of the leaves at ``path`` of
    :func:`param_tree`, or with ``unit`` one unit's views of a stacked
    position) gathered over the mesh's batch axes, the ranks of which hold
    different rows and so need the whole leaf (the training forward's
    gather, :func:`_gatherer`, over those axes alone), and the specs that
    remain: what stays cut is bound to an axis whose ranks share the rows
    (the model axis), for the tensor-parallel ops."""
    if model.shards is None:
        return tree, None
    mesh, specs = model.shards
    over = tuple(a for a in sharding.BATCH_AXES if a in mesh.shape)
    spec = _spec_at(specs, path, unit)
    return sharding.gather_tree(tree, spec, mesh, over=over), \
        tree_lib.tree_map(lambda s: sharding.unbind(s, over), spec,
                          is_leaf=sharding.is_spec)


def _check_whole(what: str, spec_tree, item: str = "16.11") -> None:
    """Raise unless every leaf that the rank path runs whole (learned
    positions, the encoder's final norm) is whole once the batch axes are
    gathered (no spec: no mesh); ``item``: the ROADMAP item that would
    take it."""
    if spec_tree is None:
        return
    mesh = sharding.current_mesh()
    for path, spec in tree_lib.paths(spec_tree, what,
                                     is_leaf=sharding.is_spec):
        if any(mesh.shape[a] > 1 for a in sharding.spec_axes(spec)
               if a not in sharding.BATCH_AXES):
            raise NotImplementedError(
                f"{path}: {spec} on {mesh}: cut over a non-batch axis, "
                f"which this layer's rank path does not take (ROADMAP "
                f"{item})")


# the mixers whose rank path takes their leaves and caches cut over the
# model axis
RANK_MIXERS = ("gqa", "global", "local", "shared", "cross", "mla", "mlstm",
               "slstm", "mamba")


def layer_pre(p, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Norm, QKV projections with bias, RoPE: x [B, L, d] → q [B, L, H, hd],
    k, v [B, L, K, hd]."""
    return attention.qkv(p["mixer"], _norm_apply(p["ln1"], x, cfg),
                         positions, cfg)


def _residual(p, post: str, x: torch.Tensor, y: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """x + y, y through the sandwich post-norm ``post`` when the config
    has them (the reference's ``_apply_layer``)."""
    if cfg.sandwich_norm:
        y = _norm_apply(p[post], y, cfg)
    return x + y


def _ffn_residual(p, ffn: str, x: torch.Tensor, cfg: ModelConfig,
                  spec=None):
    if ffn == "none":
        return x
    y = _ffn_apply(p["ffn"], ffn, _norm_apply(p["ln2"], x, cfg), cfg,
                   None if spec is None else spec["ffn"])
    return _residual(p, "ln2_post", x, y, cfg)


def layer_post(p, x: torch.Tensor, att: torch.Tensor, ffn: str,
               cfg: ModelConfig) -> torch.Tensor:
    """Output projection, residual, MLP: att [B, L, H, hd]."""
    B, L = x.shape[:2]
    y = att.reshape(B, L, -1).to(x.dtype) @ p["mixer"]["wo"]
    return _ffn_residual(p, ffn, _residual(p, "ln1_post", x, y, cfg), cfg)


# --------------------------------------------------------------------------
# the dense forward pass over slot caches
# --------------------------------------------------------------------------
def _state_one(mixer: str, cfg: ModelConfig, batch: int, dtype, device):
    """A recurrent layer's zeroed state (the reference's
    ``*_init_state``): f32 ``ssm`` / ``c`` / ``n`` / ``h``, the conv
    history at ``dtype``."""
    if mixer == "mamba":
        return ssm.mamba2_init_state(cfg.mamba, batch, dtype, device)
    if mixer == "mlstm":
        return ssm.mlstm_init_state(cfg.mlstm, batch, dtype, device)
    return ssm.slstm_init_state(cfg.slstm, batch, device)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                device=None):
    """Zeroed slot caches aligned with ``cfg.groups`` (the reference's
    ``_init_cache_one``): per group, a tuple per pattern position of
    ``{"k", "v"}`` [count, batch, K, S, hd] at ``dtype`` (default: the
    compute dtype), S = max_seq, the ring of ``min(max_seq, window)`` rows
    of a sliding-window layer, or the ``encoder_seq`` rows of a cross
    layer; or a recurrent layer's state, ``{"ssm" [count, batch, H, N,
    P] f32, "conv" [count, batch, conv_k - 1, D]}`` (Mamba2, mLSTM) or
    ``{"c", "n", "h"}`` [count, batch, H, hd] f32 (sLSTM), constant in
    ``max_seq``; or an MLA layer's latents ``{"ckv" [count, batch, S,
    kv_lora], "kr" [count, batch, S, qk_rope]}``."""
    check_supported(cfg)
    dtype = dtype or cfg.compute_dtype
    out = []
    for pattern, count in cfg.groups:
        per_pos = []
        for kind in pattern:
            mixer = parse_kind(kind)[0]
            if mixer in ssm.RECURRENT:
                one = _state_one(mixer, cfg, batch, dtype, device)
                per_pos.append({name: a[None].expand(
                    (count,) + a.shape).clone() for name, a in one.items()})
                continue
            if mixer == "mla":
                per_pos.append({name: torch.zeros(
                    (count, batch, max_seq, width), dtype=dtype,
                    device=device) for name, width in (
                        ("ckv", cfg.mla.kv_lora), ("kr", cfg.mla.qk_rope))})
                continue
            window = cfg.window_of(mixer)
            S = min(max_seq, window) if window else max_seq
            if mixer == "cross":
                S = cfg.encoder_seq
            per_pos.append({name: torch.zeros(
                (count, batch, cfg.n_kv, S, cfg.hd), dtype=dtype,
                device=device) for name in ("k", "v")})
        out.append(tuple(per_pos))
    return out


def cache_seq_axis(mixer: str) -> Optional[int]:
    """The sequence axis of a ``mixer`` layer's cache leaves as
    :func:`init_caches` makes them: 3 for K/V [count, batch, K, S, hd], 2
    for MLA's latents [count, batch, S, c], None for recurrent state."""
    if mixer in ssm.RECURRENT:
        return None
    return 2 if mixer == "mla" else 3


def cache_logical_axes(cfg: ModelConfig):
    """The logical sharding axes of each leaf of :func:`init_caches`'s tree
    (the reference's ``cache_logical_axes``): K/V over ``kv_heads_tp`` (and
    ``kv_seq`` under ``cfg.shard_kv_seq``), MLA's latents over ``kv_seq``,
    a recurrent state's heads (or its conv history's channels) over
    ``heads_tp``; every leaf leads with ``layers`` and ``batch``."""
    kv_seq = "kv_seq" if cfg.shard_kv_seq else None
    kv = ("layers", "batch", "kv_heads_tp", kv_seq, None)
    state = {"mamba": {"ssm": ("layers", "batch", "heads_tp", None, None),
                       "conv": ("layers", "batch", None, "heads_tp")},
             "slstm": {name: ("layers", "batch", "heads_tp", None)
                       for name in ("c", "n", "h")}}
    state["mlstm"] = state["mamba"]
    out = []
    for pattern, _ in cfg.groups:
        per_pos = []
        for kind in pattern:
            mixer = parse_kind(kind)[0]
            if mixer in state:
                per_pos.append(dict(state[mixer]))
            elif mixer == "mla":
                per_pos.append({name: ("layers", "batch", kv_seq, None)
                                for name in ("ckv", "kr")})
            else:
                per_pos.append({"k": kv, "v": kv})
        out.append(tuple(per_pos))
    return out


def _encoder_units(model: Transformer):
    """Walk the encoder's layers in order: (kind, layer weights, their
    specs), each unit gathered over the batch axes on a rank as
    :func:`_layers` does (specs None without a mesh)."""
    for gi, (pattern, count) in enumerate(model.cfg.encoder_groups):
        for u in range(count):
            for i, kind in enumerate(pattern):
                yield (kind, *_rank_tree(
                    model, model.encoder.groups[gi][i].unit(u), "encoder",
                    "groups", gi, i, unit=True))


def encode(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings [B, S_enc, d] at the
    model's dtype (the reference's ``_encode``): learned positions
    ``pos_embed[:S_enc]`` added, the ``enc`` layers (no cache, every frame
    attending every frame), the encoder's final norm. On one rank of a
    mesh: ``frames`` are the rank's rows; the positions and the final
    norm are whole once the batch axes are gathered; each layer runs on
    the rank's heads (``attention.encoder_forward``) and its MLP column /
    row-parallel (:func:`_ffn`)."""
    cfg, enc = model.cfg, model.encoder
    S = frames.shape[1]
    if S > cfg.encoder_seq:
        raise ValueError(f"encode: {S} frames past the encoder's "
                         f"{cfg.encoder_seq} learned positions")
    table, spec = _rank_tree(model, enc.pos_embed, "encoder", "pos_embed")
    _check_whole("encoder/pos_embed", spec)
    x = frames + table[None, :S]
    for kind, p, ps in _encoder_units(model):
        y = attention.encoder_forward(
            p["mixer"], _norm_apply(p["ln1"], x, cfg), cfg,
            None if ps is None else ps["mixer"])
        x = _ffn_residual(p, parse_kind(kind)[1],
                          _residual(p, "ln1_post", x, y, cfg), cfg, ps)
    norm, spec = _rank_tree(model, _norm_leaf(enc, "final_norm"), "encoder",
                            "final_norm")
    _check_whole("encoder/final_norm", spec)
    return _norm_apply(norm, x, cfg)


def recurrent_forward(mixer: str, p: Dict[str, torch.Tensor],
                      h: torch.Tensor, cfg: ModelConfig,
                      state: Dict[str, torch.Tensor], mode: str,
                      spec=None, cache_spec=None) -> torch.Tensor:
    """One recurrent layer (models/ssm.py) over its slots' state views,
    written in place with the new state; returns y [B, L, d]. A decode
    step continues from the state. A prefill starts from a zero state and
    zero conv history, whatever the views hold: a slot's earlier sequence
    (or the free slot's decode steps) must not leak into the next one.
    The reference's dense engine starts from the slot's state as it
    stands (see tests/test_torch_xlstm.py). On one rank of a mesh
    ``state`` is the rank's part under ``cache_spec`` and ``p`` its shards
    under ``spec``; the forward reads both."""
    start = state if mode == "decode" else \
        {name: torch.zeros_like(a) for name, a in state.items()}
    y, new = ssm.FORWARD[mixer](p, h, getattr(cfg, mixer), start, spec,
                                cache_spec)
    for name, a in state.items():
        a.copy_(new[name])
    return y


def hidden(model: Transformer, tokens: torch.Tensor, caches, cache_pos,
           mode: str, extra: Optional[torch.Tensor] = None,
           cache_specs=None) -> torch.Tensor:
    """The final hidden state [B, L, d] (before the final norm); see
    :func:`forward`. On one rank of a mesh (``model.shards``, under
    ``sharding.use_mesh``): ``tokens`` and ``caches`` are the rank's rows
    and parts, ``cache_specs`` the caches' specs, and each layer runs on
    the rank's shards (:func:`_layers`; the attention layers and
    :func:`_ffn` read each leaf's spec; ``extra`` is the rank's rows of
    the encoder input); the result is the rank's rows, whole."""
    cfg = model.cfg
    B, L = tokens.shape
    rank = model.shards is not None
    if not rank:     # whole leaves: a one-rank mesh's cache specs bind none
        cache_specs = None
    elif cache_specs is None:
        raise ValueError("a sharded model's serving step needs its caches' "
                         "specs (train/step.py rank_caches)")
    if mode == "decode":
        if not isinstance(cache_pos, torch.Tensor) or L != 1:
            raise ValueError("decode: one token a slot and a [B] cache_pos "
                             "tensor")
        positions = cache_pos.long()[:, None]
    elif mode == "prefill":
        if isinstance(cache_pos, torch.Tensor) or cache_pos != 0:
            raise ValueError("prefill runs every slot from position 0")
        positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
    else:
        raise ValueError(f"mode {mode!r}: expected 'prefill' or 'decode'")
    x = embed(model, tokens)
    if cfg.learned_pos:     # past the table, the last row (the reference)
        table, spec = _rank_tree(model, model.pos_embed, "pos_embed")
        _check_whole("pos_embed", spec)
        x = x + blocks.embed_lookup(
            table, positions.clamp(max=cfg.learned_pos - 1))
    if mode == "decode":    # cross layers read their caches
        extra = None
    elif has_cross(cfg):
        if extra is None:
            raise ValueError(f"{cfg.name}: a prefill needs the encoder input "
                             "`extra` (stub image / audio embeddings)")
        extra = extra.to(x.dtype)
        if model.encoder is not None:
            extra = encode(model, extra)
    for kind, p, ps, cache, cs in _layers(model, caches, cache_specs):
        mixer, ffn = parse_kind(kind)
        h = _norm_apply(p["ln1"], x, cfg)
        spec = None if ps is None else ps["mixer"]
        if mixer in ssm.RECURRENT:
            y = recurrent_forward(mixer, p["mixer"], h, cfg, cache, mode,
                                  spec, cs)
        elif mixer == "cross":
            y = attention.cross_forward(p["mixer"], h, cfg, cache, extra,
                                        spec, cs)
        elif mixer == "mla":
            y = attention.mla_forward(p["mixer"], h, positions, cfg.mla,
                                      cache, cache_pos, spec, cs)
        else:
            y = attention.gqa_forward(
                p["mixer"], h, positions, cfg, cache, cache_pos,
                window=cfg.window_of(mixer), spec=spec, cache_spec=cs)
        x = _ffn_residual(p, ffn, _residual(p, "ln1_post", x, y, cfg), cfg,
                          ps)
    return x


def forward(model: Transformer, tokens: torch.Tensor, caches=None,
            cache_pos=0, mode: str = "train",
            extra: Optional[torch.Tensor] = None,
            next_tokens: Optional[torch.Tensor] = None):
    """tokens [B, L] int over ``caches`` from :func:`init_caches` (written
    in place) → (logits [B, L, vocab], caches); with ``mode="train"`` (no
    caches) → (logits, aux) from :func:`train_forward`.

    ``mode="prefill"``: ``cache_pos`` 0, every slot's prompt from position
    0 (a recurrent layer from a zero state). ``mode="decode"``: L = 1 and ``cache_pos`` a [B] int tensor, slot b
    writing and reading at its own position ``cache_pos[b]`` (the
    reference's decode takes one shared position; see models/attention.py).
    ``extra``: a cross-attention model's encoder input at prefill (stub
    image patches [B, encoder_seq, cross_kv_dim], or whisper's frames [B,
    S_enc, d], which :func:`encode` runs first); a decode step reads the
    cross caches and takes none.
    The model's weights must be at the compute dtype (serve/executor.py
    casts them once).
    """
    if mode == "train":
        if caches is not None:
            raise ValueError("forward: mode 'train' runs with no caches")
        return train_forward(model, tokens, extra, next_tokens)
    return logits(model, hidden(model, tokens, caches, cache_pos, mode,
                                extra)), caches


# --------------------------------------------------------------------------
# the training forward: no caches, each unit cast where the reference casts
# --------------------------------------------------------------------------
def _cast(tree, dtype):
    """Every floating leaf of ``tree`` at ``dtype`` (the reference's
    ``_cast``: the f32 router and ``w_if`` too); differentiable, a no-op
    copy-free at its own dtype."""
    return tree_lib.tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def _train_layer(kind: str, p, x: torch.Tensor, positions: torch.Tensor,
                 extra: Optional[torch.Tensor], cfg: ModelConfig,
                 shared, spec=None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer with no cache (the reference's ``_apply_layer`` in train
    mode): (x, the MoE's aux or None). A ``shared`` site takes
    ``shared``'s mixer and MLP (``shared``: the block's leaves and their
    specs, None without a mesh). ``spec``: on one rank of a mesh, the
    specs of ``p`` once the batch axes are gathered (:func:`_rank_tree`):
    every mixer (GQA, encoder, cross, MLA and recurrent) and :func:`_ffn`
    then run on the rank's shards, as in serving, with the collectives'
    gradients of parallel/sharding.py."""
    mixer, ffn = parse_kind(kind)
    if mixer == "shared":
        p = dict(p, mixer=shared[0]["mixer"], ffn=shared[0]["ffn"])
        if spec is not None:
            spec = dict(spec, **shared[1])
    sp = None if spec is None else spec["mixer"]
    h = _norm_apply(p["ln1"], x, cfg)
    if mixer in ssm.RECURRENT:
        y = ssm.FORWARD[mixer](p["mixer"], h, getattr(cfg, mixer), None,
                               sp)[0]
    elif mixer == "cross":
        y = attention.cross_forward(p["mixer"], h, cfg, None, extra, sp)
    elif mixer == "mla":
        y = attention.mla_forward(p["mixer"], h, positions, cfg.mla,
                                  spec=sp)
    else:
        y = attention.gqa_forward(p["mixer"], h, positions, cfg, None, 0,
                                  window=cfg.window_of(mixer),
                                  causal=mixer != "enc", spec=sp)
    x = _residual(p, "ln1_post", x, y, cfg)
    if ffn == "none":
        return x, None
    y, aux = _ffn(p["ffn"], ffn, _norm_apply(p["ln2"], x, cfg), cfg,
                  None if spec is None else spec["ffn"])
    return _residual(p, "ln2_post", x, y, cfg), aux


def _train_unit(pattern: Pattern, unit_p, positions, extra, cfg, shared,
                leaves, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One unit of a group: its layers' leaves gathered by ``leaves``
    (each position's (leaves, specs): FSDP's gather over the batch axes,
    inside the remat region, so the backward gathers them again) and cast
    to the compute dtype (inside the region, as the reference casts
    inside its scan body), then each layer on them; (x, Σ aux)."""
    gathered = leaves(unit_p)
    unit_p = _cast([p for p, _ in gathered], cfg.compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p, (_, spec) in zip(pattern, unit_p, gathered):
        x, a = _train_layer(kind, p, x, positions, extra, cfg, shared, spec)
        if a is not None:
            aux = aux + a
    return x, aux


def _train_groups(stacks: nn.ModuleList, groups, x: torch.Tensor,
                  positions: torch.Tensor, extra, cfg: ModelConfig, shared,
                  leaves) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every unit of ``groups`` in order, each under
    ``torch.utils.checkpoint`` when ``cfg.remat`` is not ``"none"`` (the
    reference's ``jax.checkpoint`` of its scan body: its ``"full"`` saves
    nothing inside a unit, and so does this; ``"dots"``, which no config
    sets, is taken as ``"full"``); (x, Σ aux in f32, a group at a time).
    ``leaves(tree, gi, i)``: position ``i`` of group ``gi``'s unit leaves
    and their specs (:func:`_rank_tree`)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    mesh = sharding.current_mesh()
    rules = sharding.current_rules()
    for gi, (pattern, count) in enumerate(groups):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for u in range(count):
            unit = functools.partial(
                _in_mesh, mesh, rules, _train_unit, pattern,
                [stacks[gi][i].unit(u) for i in range(len(pattern))],
                positions, extra, cfg, shared,
                lambda ps, gi=gi: [leaves(p, gi, i) for i, p in enumerate(ps)])
            if cfg.remat != "none":
                x, a = checkpoint(unit, x, use_reentrant=False)
            else:
                x, a = unit(x)
            aux = aux + a
        aux_total = aux_total + aux
    return x, aux_total


def _in_mesh(mesh, rules, fn, *args):
    """``fn(*args)`` under ``mesh`` and ``rules`` (none: as it stands). A
    remat region is recomputed in the backward, which on the card runs on
    autograd's device thread, where this thread's mesh is not active: the
    recomputation must read the specs the forward read."""
    if mesh is None:
        return fn(*args)
    with sharding.use_mesh(mesh, rules):
        return fn(*args)


def _spec_at(specs, path, unit: bool = False):
    """The spec tree at ``path`` of ``specs``; with ``unit``, one unit's of
    a stacked position (the stacked axis, which no rule binds, dropped)."""
    for key in path:
        specs = specs[key]
    if unit:
        specs = tree_lib.tree_map(lambda p: p[1:], specs,
                                  is_leaf=sharding.is_spec)
    return specs


def _train_encode(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder in the training forward (the reference's
    ``_encode``): frames [B, S_enc, d] at the compute dtype. On a rank
    each ``enc`` layer runs on its shards as :func:`_train_layer` runs a
    GQA layer (non-causal); the positions and the final norm are whole
    once the batch axes are gathered."""
    cfg, enc = model.cfg, model.encoder
    S = frames.shape[1]
    if S > cfg.encoder_seq:
        raise ValueError(f"encode: {S} frames past the encoder's "
                         f"{cfg.encoder_seq} learned positions")
    table, spec = _rank_tree(model, enc.pos_embed, "encoder", "pos_embed")
    _check_whole("encoder/pos_embed", spec)
    x = frames + table.to(cfg.compute_dtype)[None, :S]
    pos = torch.arange(S, device=x.device)[None].expand(frames.shape[:2])
    x, _ = _train_groups(
        enc.groups, cfg.encoder_groups, x, pos, None, cfg, None,
        lambda t, gi, i: _rank_tree(model, t, "encoder", "groups", gi, i,
                                    unit=True))
    norm, spec = _rank_tree(model, _norm_leaf(enc, "final_norm"), "encoder",
                            "final_norm")
    _check_whole("encoder/final_norm", spec)
    return _norm_apply(_cast(norm, cfg.compute_dtype), x, cfg)


def train_forward(model: Transformer, tokens: torch.Tensor,
                  extra: Optional[torch.Tensor] = None,
                  next_tokens: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The reference's ``forward(mode="train")``: tokens [B, L] from
    position 0, no caches → (logits [B, L, vocab], aux ``{"moe_aux"}``,
    with ``"mtp_logits"`` when ``cfg.mtp`` and ``next_tokens`` are given).

    The weights stay at their own dtype (f32 master weights) and are cast
    to the compute dtype where the reference casts them: the embedding
    (also the tied head), ``pos_embed``, the final norm, the shared block,
    the encoder's positions and norm, the MTP head, and each unit's leaves
    inside its remat region, so gradients land in the weights' dtype.
    Every attention layer runs ``flash_xla`` (models/attention.py), never
    a serving kernel. ``extra``: the encoder input of a cross-attention
    model (stub patches [B, encoder_seq, cross_kv_dim], or whisper's frames
    [B, S_enc, d], which the encoder runs first). The MTP head (deepseek):
    the final normed hidden state beside ``embed[next_tokens]``, through
    ``mtp.proj``, one layer of the last kind, the norm and the head.

    On one rank of a mesh (``model.shards``: train/step.py
    ``shard_state``) ``tokens`` are the rank's rows, each leaf is gathered
    over the batch axes where it is used (:func:`_rank_tree`, inside each
    unit's remat region) and the model axis runs tensor-parallel as the
    serving forward does: the vocabulary-cut embedding summed over its
    line (:func:`embed`'s lookup), every layer on the rank's shards
    (:func:`_train_layer`: the attention of every kind, the encoder's and
    the shared block's included, on the rank's heads, the recurrent
    mixers on theirs, :func:`_ffn` column / row-parallel or the MoE's mesh
    paths), with the collectives' gradients of parallel/sharding.py. The
    head returns the rank's logits over its part of the vocabulary, and
    then ``aux["vocab"]`` is that part (a ``sharding.Held``:
    train/loss.py's vocabulary-parallel loss reads it); so do the MTP
    head's logits, whose block runs on the ``mtp`` leaves' shards. Learned
    positions cut over the model axis refuse (no rule cuts them)."""
    cfg = model.cfg
    cd = cfg.compute_dtype
    B, L = tokens.shape
    positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
    table, e_spec = _rank_tree(model, model.embed, "embed")
    embed_w = table.to(cd)
    x = _lookup(embed_w, e_spec, tokens)
    if cfg.embed_scale:
        x = x * embed_scale(cfg.d_model, cd)
    if cfg.learned_pos:
        table, spec = _rank_tree(model, model.pos_embed, "pos_embed")
        _check_whole("pos_embed", spec)
        x = x + blocks.embed_lookup(table.to(cd),
                                    positions.clamp(0, cfg.learned_pos - 1))
    if cfg.encoder_groups:
        if extra is None:
            raise ValueError(f"{cfg.name}: the training forward needs the "
                             "encoder input `extra`")
        extra = _train_encode(model, extra.to(cd))
    elif extra is not None:
        extra = extra.to(cd)
    if has_cross(cfg) and extra is None:
        raise ValueError(f"{cfg.name}: the training forward needs the "
                         "encoder input `extra` (stub image embeddings)")
    shared = None
    if model.shared_block is not None:
        shared, spec = _rank_tree(model, param_tree(model)["shared_block"],
                                  "shared_block")
        shared = (_cast(shared, cd), spec)
    x, moe_aux = _train_groups(
        model.groups, cfg.groups, x, positions, extra, cfg, shared,
        lambda t, gi, i: _rank_tree(model, t, "groups", gi, i, unit=True))
    norm, _ = _rank_tree(model, _norm_leaf(model, "final_norm"), "final_norm")
    h_final = _norm_apply(_cast(norm, cd), x, cfg)
    mesh = sharding.current_mesh()
    if cfg.tie_embeddings:
        head, cols = embed_w.t(), sharding.held(embed_w, e_spec, 0, mesh)
    else:
        lm, spec = _rank_tree(model, model.lm_head, "lm_head")
        head, cols = lm.to(cd), sharding.held(lm, spec, 1, mesh)
    aux: Dict[str, Any] = {"moe_aux": moe_aux}

    def head_of(h):     # each rank's columns of the vocabulary differ
        return (h if cols.line is None else
                sharding.copy_to(h, cols.line)) @ head
    if cols.line is not None:
        aux["vocab"] = cols
    if cfg.mtp and next_tokens is not None:
        mtp_p, spec = _rank_tree(model, param_tree(model)["mtp"], "mtp")
        mtp_p = _cast(mtp_p, cd)
        e_next = _lookup(embed_w, e_spec, next_tokens)
        h_mtp = torch.cat([h_final, e_next], dim=-1) @ mtp_p["proj"]
        h_mtp, _ = _train_layer(cfg.groups[-1][0][-1], mtp_p["block"], h_mtp,
                                positions, extra, cfg, shared,
                                None if spec is None else spec["block"])
        aux["mtp_logits"] = head_of(_norm_apply(mtp_p["norm"], h_mtp, cfg))
    return head_of(h_final), aux
