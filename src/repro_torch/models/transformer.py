"""Model configuration and weights for the paged serving path.

Counterpart of ``repro/models/transformer.py``, limited to what the chunked
paged serving path runs: groups of full-attention GQA layers with dense
MLPs. :class:`ModelConfig` keeps every field of the reference so that the
configs read the same, with torch dtypes in place of jnp ones
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
with a leading ``count`` axis on every leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import blocks

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


def parse_kind(kind: str) -> Tuple[str, str]:
    mixer, _, ffn = kind.partition(":")
    return mixer, ffn or "mlp"


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is on this port's path: full-attention mixers
    with dense swiglu MLPs, RMS norm, no shared block, no softcap."""
    for pattern, _ in cfg.groups:
        for kind in pattern:
            mixer, ffn = parse_kind(kind)
            if mixer not in ("gqa", "global"):
                raise NotImplementedError(
                    f"repro_torch: mixer {mixer!r} is not ported yet "
                    "(ROADMAP queue 1, item 16)")
            if ffn not in ("mlp", "none"):
                raise NotImplementedError(
                    f"repro_torch: ffn {ffn!r} is not ported yet "
                    "(ROADMAP queue 1, item 16)")
    if cfg.mlp != "swiglu" or cfg.norm != "rms" or cfg.sandwich_norm or \
            cfg.logit_softcap or cfg.window:
        raise NotImplementedError(
            f"repro_torch: {cfg.name} needs blocks not ported yet "
            "(ROADMAP queue 1, item 4 and 16)")


# --------------------------------------------------------------------------
# init: same distributions as the reference (not the same numbers)
# --------------------------------------------------------------------------
def _normal(shape, std: float, generator, device, dtype):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(0.0, 1.0, generator=generator)
    return (w * std).to(dtype)


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> "Transformer":
    """Random weights drawn from the reference's distributions
    (``transformer.py:217-255`` and ``attention.init_gqa``): dense weights
    N(0, 1/fan_in), ``wo`` N(0, 1/(H·hd)), the embedding N(0, 0.02²), norm
    scales 1 and QKV biases 0. ``generator`` must live on ``device`` (a
    ``meta`` device allocates nothing, for counting parameters)."""
    check_supported(cfg)
    device = torch.device(device if device is not None else "cpu")
    dt = cfg.param_dtype
    d, f, H, K, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv, cfg.hd

    def normal(shape, std):
        return _normal(shape, std, generator, device, dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

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
            layer = {"ln1": {"scale": ones((count, d))}, "mixer": mixer}
            if ffn != "none":
                layer["ln2"] = {"scale": ones((count, d))}
                layer["ffn"] = {
                    "w_gate": normal((count, d, f), 1 / math.sqrt(d)),
                    "w_up": normal((count, d, f), 1 / math.sqrt(d)),
                    "w_down": normal((count, f, d), 1 / math.sqrt(f))}
            per_pos.append(layer)
        groups.append(tuple(per_pos))
    params: Dict[str, Any] = {
        "embed": normal((cfg.vocab, d), 0.02),
        "final_norm": {"scale": ones((d,))},
        "groups": groups,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab), 1 / math.sqrt(d))
    return Transformer(cfg, params)


def count_params(model: "Transformer") -> int:
    return sum(p.numel() for p in model.parameters())


# --------------------------------------------------------------------------
# the module: the reference's parameter tree, leaf for leaf
# --------------------------------------------------------------------------
class LayerStack(nn.Module):
    """One pattern position of a group: ``count`` layers' weights stacked
    along axis 0, named as in the reference tree (``ln1``, ``mixer.*``,
    ``ln2``, ``ffn.*``). ``unit(u)`` gives layer ``u``'s views."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.ln1 = _frozen(tree["ln1"]["scale"])
        self.mixer = nn.ParameterDict(
            {k: _frozen(v) for k, v in tree["mixer"].items()})
        self.has_ffn = "ffn" in tree
        if self.has_ffn:
            self.ln2 = _frozen(tree["ln2"]["scale"])
            self.ffn = nn.ParameterDict(
                {k: _frozen(v) for k, v in tree["ffn"].items()})

    @property
    def count(self) -> int:
        return self.ln1.shape[0]

    def unit(self, u: int) -> Dict[str, Any]:
        out = {"ln1": {"scale": self.ln1[u]},
               "mixer": {k: v[u] for k, v in self.mixer.items()}}
        if self.has_ffn:
            out["ln2"] = {"scale": self.ln2[u]}
            out["ffn"] = {k: v[u] for k, v in self.ffn.items()}
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
# layer pieces used by serve/paged_step.py
# --------------------------------------------------------------------------
def _norm_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return blocks.rms_norm(p["scale"], x, zero_centered=cfg.zero_centered_norm)


def _ffn_apply(p, ffn: str, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if ffn != "mlp" or cfg.mlp != "swiglu":
        raise NotImplementedError(f"repro_torch: ffn {ffn!r}/{cfg.mlp!r}")
    return blocks.swiglu(p["w_gate"], p["w_up"], p["w_down"], x)
