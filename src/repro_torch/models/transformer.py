"""Model configuration, weights and the dense forward pass for serving.

Counterpart of ``repro/models/transformer.py``, limited to what the
serving paths run: groups of GQA layers, full-attention (``gqa``,
``global``) or sliding-window (``local``, a ring of ``min(max_seq,
window)`` cache rows), with dense MLPs or a capacity-dispatched MoE
(models/moe.py), RMS norms (zero-centred scales and sandwich post-norms
where the config asks) and an optionally scaled embedding.
:func:`forward` runs prefill and decode over dense slot caches
(:func:`init_caches`, models/attention.py); the paged steps
(serve/paged_step.py) walk the same layers with the same pieces
(:func:`embed`, :func:`layer_pre`, :func:`layer_post`, :func:`logits`)
over a page pool. :class:`ModelConfig` keeps every field of the reference
so that the configs read the same, with torch dtypes in place of jnp ones
(``compute_dtype=torch.float32`` works as the reference override does).

Weights keep the reference layout: ``y = x @ w`` with ``w`` of shape
``[d_in, d_out]``, and each group's per-layer weights stacked along a
leading ``[count, ...]`` axis, so carrying reference weights across
(models/convert.py) is a copy, never a transpose. :class:`Transformer`
holds the reference's parameter tree leaf for leaf::

    {"embed": [vocab, d], "final_norm": {"scale": [d]},
     "groups": [ (pos0, pos1, ...) per group ]}

where each pattern position holds ``{"ln1": {"scale"}, "mixer": {wq, wk,
wv, wo[, bq, bk, bv]}, "ln2": {"scale"}, "ffn": {w_gate, w_up, w_down}}``
(``{w_in, w_out}`` for ``mlp="relu2"``; ``{router, w_gate, w_up, w_down[,
shared: {w_gate, w_up, w_down}]}`` for a ``moe`` ffn, the experts on an
``[E, ...]`` axis; ``ln1_post`` / ``ln2_post`` beside them under
``sandwich_norm``) with a leading ``count`` axis on every leaf.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention, blocks
from repro_torch.models import moe as moe_lib

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
    moe: Optional[moe_lib.MoeConfig] = None
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
        return sum(len(p) * c for p, c in self.groups)

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


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is on this port's path: full-attention or
    sliding-window mixers with dense swiglu or squared-ReLU MLPs or a MoE
    (with ``cfg.moe`` set), RMS norm, no shared block, no softcap."""
    for pattern, _ in cfg.groups:
        for kind in pattern:
            mixer, ffn = parse_kind(kind)
            if mixer not in ("gqa", "global", "local"):
                raise NotImplementedError(
                    f"repro_torch: mixer {mixer!r} is not ported yet "
                    "(ROADMAP queue 1, item 16)")
            if ffn not in ("mlp", "none") and not (
                    ffn == "moe" and cfg.moe is not None):
                raise NotImplementedError(
                    f"repro_torch: ffn {ffn!r} is not ported yet "
                    "(ROADMAP queue 1, item 16)")
    if cfg.mlp not in ("swiglu", "relu2") or cfg.norm != "rms" or \
            cfg.logit_softcap:
        raise NotImplementedError(
            f"repro_torch: {cfg.name} needs blocks not ported yet "
            "(ROADMAP queue 1, item 4 and 16)")


# --------------------------------------------------------------------------
# init: same distributions as the reference (not the same numbers)
# --------------------------------------------------------------------------
DRAW_ELEMS = 2**28    # most elements of a 2-D leaf drawn in one f32 piece


def _normal(shape, std: float, generator, device, dtype):
    """N(0, std²) at ``dtype``, drawn in f32 one ``[count]`` slice of a
    stacked leaf at a time: a whole f32 draw of yi-34b's ``[60, 7168,
    20480]`` MLP leaves would need a 35 GB temporary beside the weights.
    A 2-D leaf of more than ``DRAW_ELEMS`` elements is drawn in runs of
    whole rows of at most that many (gemma3-27b's ``[262144, 5376]``
    embedding whole would be a 5.6 GB temporary)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    if len(shape) > 2:
        parts = out
    elif len(shape) == 2:
        parts = out.split(max(1, DRAW_ELEMS // max(1, shape[1])))
    else:
        parts = (out,)
    for part in parts:
        w = torch.empty(part.shape, dtype=torch.float32, device=device)
        part.copy_(w.normal_(0.0, 1.0, generator=generator).mul_(std))
    return out


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> "Transformer":
    """Random weights drawn from the reference's distributions
    (``transformer.py:165-167, 217-255`` and ``attention.init_gqa``):
    dense weights N(0, 1/fan_in), ``wo`` N(0, 1/(H·hd)), the embedding
    N(0, 0.02²), norm scales 1 (0 when zero-centred: the norm multiplies
    by 1 + scale), sandwich post-norms beside them, QKV biases 0, and a
    MoE's leaves as ``moe.leaf_shapes`` says (the router f32 whatever
    ``param_dtype``).
    Leaves are made at ``cfg.param_dtype`` (a full-width model at bf16 passes
    ``param_dtype=torch.bfloat16``, so the executor's cast to the compute
    dtype copies nothing). ``generator`` must live on ``device`` (a
    ``meta`` device allocates nothing, for counting parameters)."""
    check_supported(cfg)
    device = torch.device(device if device is not None else "cpu")
    dt = cfg.param_dtype
    d, f, H, K, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv, cfg.hd

    def normal(shape, std):
        return _normal(shape, std, generator, device, dt)

    def norm(shape):
        fill = torch.zeros if cfg.zero_centered_norm else torch.ones
        return {"scale": fill(shape, dtype=dt, device=device)}

    groups = []
    for pattern, count in cfg.groups:
        per_pos = []
        for kind in pattern:
            _, ffn = parse_kind(kind)
            mixer = {"wq": normal((count, d, H * hd), 1 / math.sqrt(d)),
                     "wk": normal((count, d, K * hd), 1 / math.sqrt(d)),
                     "wv": normal((count, d, K * hd), 1 / math.sqrt(d)),
                     "wo": normal((count, H * hd, d), 1 / math.sqrt(H * hd))}
            if cfg.qkv_bias:
                for b, n in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
                    mixer[b] = torch.zeros((count, n), dtype=dt, device=device)
            layer = {"ln1": norm((count, d)), "mixer": mixer}
            if ffn == "moe":
                layer["ln2"] = norm((count, d))
                layer["ffn"] = _init_moe(cfg.moe, count, generator, device,
                                         dt)
            elif ffn != "none":
                layer["ln2"] = norm((count, d))
                layer["ffn"] = (
                    {"w_in": normal((count, d, f), 1 / math.sqrt(d)),
                     "w_out": normal((count, f, d), 1 / math.sqrt(f))}
                    if cfg.mlp == "relu2" else
                    {"w_gate": normal((count, d, f), 1 / math.sqrt(d)),
                     "w_up": normal((count, d, f), 1 / math.sqrt(d)),
                     "w_down": normal((count, f, d), 1 / math.sqrt(f))})
            if cfg.sandwich_norm:
                layer["ln1_post"] = norm((count, d))
                if ffn != "none":
                    layer["ln2_post"] = norm((count, d))
            per_pos.append(layer)
        groups.append(tuple(per_pos))
    params: Dict[str, Any] = {
        "embed": normal((cfg.vocab, d), 0.02),
        "final_norm": norm((d,)),
        "groups": groups,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab), 1 / math.sqrt(d))
    return Transformer(cfg, params)


def _init_moe(cfg: moe_lib.MoeConfig, count: int, generator, device, dt):
    out: Dict[str, Any] = {}
    for name, shape in moe_lib.leaf_shapes(cfg).items():
        w = _normal((count,) + shape, 1 / math.sqrt(shape[0]), generator,
                    device, torch.float32 if name == "router" else dt)
        head, _, leaf = name.rpartition(".")
        (out.setdefault(head, {}) if head else out)[leaf] = w
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
    ``ln2_post`` where the tree has them). A MoE's shared experts
    (``ffn.shared.*`` in the tree) sit in ``ffn_shared``. ``unit(u)``
    gives layer ``u``'s views."""
    POST = ("ln1_post", "ln2_post")

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.ln1 = _frozen(tree["ln1"]["scale"])
        self.mixer = nn.ParameterDict(
            {k: _frozen(v) for k, v in tree["mixer"].items()})
        self.has_ffn = "ffn" in tree
        if self.has_ffn:
            self.ln2 = _frozen(tree["ln2"]["scale"])
            ffn = dict(tree["ffn"])
            shared = ffn.pop("shared", None)
            self.ffn = nn.ParameterDict(
                {k: _frozen(v) for k, v in ffn.items()})
            self.ffn_shared = None if shared is None else nn.ParameterDict(
                {k: _frozen(v) for k, v in shared.items()})
        self.post = tuple(n for n in self.POST if n in tree)
        for name in self.post:
            setattr(self, name, _frozen(tree[name]["scale"]))

    @property
    def count(self) -> int:
        return self.ln1.shape[0]

    def unit(self, u: int) -> Dict[str, Any]:
        out = {"ln1": {"scale": self.ln1[u]},
               "mixer": {k: v[u] for k, v in self.mixer.items()}}
        if self.has_ffn:
            out["ln2"] = {"scale": self.ln2[u]}
            out["ffn"] = {k: v[u] for k, v in self.ffn.items()}
            if self.ffn_shared is not None:
                out["ffn"]["shared"] = {k: v[u] for k, v in
                                        self.ffn_shared.items()}
        for name in self.post:
            out[name] = {"scale": getattr(self, name)[u]}
        return out


class Transformer(nn.Module):
    """The serving model's weights (``embed``, ``final_norm``, ``groups``,
    optional ``lm_head``) in the reference layout; the paged steps
    (serve/paged_step.py) are plain functions over it. Weights carry no
    gradient: this port serves, it does not train yet."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(tree["embed"])
        self.final_norm = _frozen(tree["final_norm"]["scale"])
        self.groups = nn.ModuleList(
            nn.ModuleList(LayerStack(pos) for pos in group)
            for group in tree["groups"])
        self.lm_head = (_frozen(tree["lm_head"]) if "lm_head" in tree
                        else None)

    def head(self) -> torch.Tensor:
        """[d, vocab]: the tied embedding's transpose or the LM head."""
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------------------
# layer pieces: the dense forward below and serve/paged_step.py
# --------------------------------------------------------------------------
def _norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return blocks.rms_norm(p["scale"], x, zero_centered=cfg.zero_centered_norm)


def _ffn_apply(p, ffn: str, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if ffn == "moe":    # aux dropped, as the reference's serving steps do
        return moe_lib.moe_forward(p, x, cfg.moe)[0]
    if ffn == "mlp" and cfg.mlp == "swiglu":
        return blocks.swiglu(p["w_gate"], p["w_up"], p["w_down"], x)
    if ffn == "mlp" and cfg.mlp == "relu2":
        return blocks.relu2_mlp(p["w_in"], p["w_out"], x)
    raise NotImplementedError(f"repro_torch: ffn {ffn!r}/{cfg.mlp!r}")


def units(model: Transformer, caches):
    """Walk every layer in order: (kind, layer weights, that layer's views
    of ``caches``). Cache leaves carry a leading ``[count]`` axis per group
    position (dense slot caches from :func:`init_caches`, or page pools);
    a layer's view drops it."""
    for gi, (pattern, count) in enumerate(model.cfg.groups):
        for u in range(count):
            for i, kind in enumerate(pattern):
                yield (kind, model.groups[gi][i].unit(u),
                       {name: arr[u] for name, arr in caches[gi][i].items()})


@functools.lru_cache(maxsize=None)
def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """√d_model rounded to ``dtype`` first, as the reference's
    ``jnp.asarray(sqrt(d), compute_dtype)``: in bf16 √5376 = 73.32 is
    73.5. The product with it is then one rounding, as in the reference."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    x = blocks.embed_lookup(model.embed, tokens)
    if model.cfg.embed_scale:
        x = x * embed_scale(model.cfg.d_model, x.dtype)
    return x


def logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    h = _norm_apply({"scale": model.final_norm}, x, model.cfg)
    return h @ model.head()


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


def _ffn_residual(p, ffn: str, x: torch.Tensor, cfg: ModelConfig):
    if ffn == "none":
        return x
    y = _ffn_apply(p["ffn"], ffn, _norm_apply(p["ln2"], x, cfg), cfg)
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
def init_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                device=None):
    """Zeroed slot caches aligned with ``cfg.groups``: per group, a tuple
    per pattern position of ``{"k", "v"}`` [count, batch, K, S, hd] at
    ``dtype`` (default: the compute dtype), S = max_seq, or the ring of
    ``min(max_seq, window)`` rows of a sliding-window layer (the
    reference's ``_init_cache_one``)."""
    check_supported(cfg)
    dtype = dtype or cfg.compute_dtype
    out = []
    for pattern, count in cfg.groups:
        per_pos = []
        for kind in pattern:
            window = cfg.window_of(parse_kind(kind)[0])
            S = min(max_seq, window) if window else max_seq
            per_pos.append({name: torch.zeros(
                (count, batch, cfg.n_kv, S, cfg.hd), dtype=dtype,
                device=device) for name in ("k", "v")})
        out.append(tuple(per_pos))
    return out


def hidden(model: Transformer, tokens: torch.Tensor, caches, cache_pos,
           mode: str) -> torch.Tensor:
    """The final hidden state [B, L, d] (before the final norm); see
    :func:`forward`."""
    cfg = model.cfg
    B, L = tokens.shape
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
    for kind, p, cache in units(model, caches):
        mixer, ffn = parse_kind(kind)
        y = attention.gqa_forward(p["mixer"], _norm_apply(p["ln1"], x, cfg),
                                  positions, cfg, cache, cache_pos,
                                  window=cfg.window_of(mixer))
        x = _ffn_residual(p, ffn, _residual(p, "ln1_post", x, y, cfg), cfg)
    return x


def forward(model: Transformer, tokens: torch.Tensor, caches, cache_pos,
            mode: str):
    """tokens [B, L] int over ``caches`` from :func:`init_caches` (written
    in place) → (logits [B, L, vocab], caches).

    ``mode="prefill"``: ``cache_pos`` 0, every slot's prompt from position
    0. ``mode="decode"``: L = 1 and ``cache_pos`` a [B] int tensor, slot b
    writing and reading at its own position ``cache_pos[b]`` (the
    reference's decode takes one shared position; see models/attention.py).
    The model's weights must be at the compute dtype (serve/executor.py
    casts them once).
    """
    return logits(model, hidden(model, tokens, caches, cache_pos, mode)), \
        caches
