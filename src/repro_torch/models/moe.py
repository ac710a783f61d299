"""Mixture-of-Experts: a top-k router and capacity-based dispatch.

Counterpart of ``repro/models/moe.py`` on its meshless path, the one
serving takes (no mesh is set): ``moe_forward`` routes every token of the
call to ``top_k`` experts, each expert takes its top-C tokens by gate
(``capacity``), and a token past an expert's capacity simply loses that
expert's term (no renormalisation). The tokens of one call therefore
compete for capacity: a row's output depends on the other rows of the
same call.

Semantics kept from the reference (the same selections; values within the
rounding of the f32 products):

  * router logits are f32 products of the input and the router; gates are
    cast back to the input's dtype;
  * ``gate_mat`` [N, E] is f32 (``capacity`` keeps C ≤ N, so the
    reference's rows past N never occur); each expert selects its top C
    tokens, equal gates in token order (``jax.lax.top_k``'s order: here a
    stable descending sort, since ``torch.topk`` leaves the order of ties
    undefined on CUDA); a selection with gate 0 maps to token 0 with zero
    weight;
  * the combine sums a token's terms in ascending expert order, each add
    rounded at the compute dtype, as the reference's scatter-add does. It
    gathers, never scatters with atomics, so a second run gives the same
    bits.

Every step is differentiable in the gates and the expert weights (the
gate matrix is scattered out of place, the selections and the combine are
index ops), so the training forward runs the same code, and
:func:`moe_forward`'s aux term reaches its loss.

Shapes are static (C from host ints): the path has no device→host read.
The expert products are ``torch.bmm``, as the reference computes them
outside any Pallas kernel. :class:`MoeConfig` keeps every field of the
reference; ``ep`` and ``dispatch`` are carried for the configs to read
the same, and not acted on (the port has no mesh).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import blocks


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    n_shared: int = 0            # shared experts (deepseek: 1)
    router: str = "softmax"      # "softmax" | "sigmoid" (deepseek-v3)
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    ep: bool = True              # expert-parallel over 'model' (no mesh here)
    dispatch: str = "gather"     # "gather" | "a2a" (no mesh here)


def leaf_shapes(cfg: MoeConfig) -> Dict[str, Tuple[int, ...]]:
    """The reference's ``init_moe`` leaves and their shapes (``shared.*``
    when ``n_shared`` > 0). ``dense_init`` draws each N(0, 1/shape[0]):
    the router N(0, 1/d), every expert leaf N(0, 1/E) (its first axis is
    the expert axis), a shared leaf N(0, 1/fan_in); the router is f32."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    out = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
           "w_down": (E, f, d)}
    if cfg.n_shared:
        fs = f * cfg.n_shared
        out.update({"shared.w_gate": (d, fs), "shared.w_up": (d, fs),
                    "shared.w_down": (fs, d)})
    return out


def _top_k(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, descending,
    equal values in index order."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg: MoeConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_flat [N, d] → (gates [N, k] at x's dtype, expert ids [N, k]
    int32, the switch load-balance aux loss)."""
    logits = x_flat.float() @ router_w.float()                 # [N, E]
    if cfg.router == "sigmoid":   # deepseek-v3: sigmoid scores, renorm top-k
        gates, idx = _top_k(torch.sigmoid(logits), cfg.top_k)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        gates, idx = _top_k(torch.softmax(logits, dim=-1), cfg.top_k)
    # switch-style load-balance aux: E * Σ_e fraction_e · mean_prob_e
    me = torch.softmax(logits, dim=-1).mean(0)
    experts = torch.arange(cfg.n_experts, device=logits.device)
    ce = (idx[:, :1] == experts).float().mean(0)           # one-hot of top-1
    aux = cfg.n_experts * torch.sum(me * ce)
    return gates.to(x_flat.dtype), idx.to(torch.int32), aux


def capacity(n_tokens: int, cfg: MoeConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return min(n_tokens, max(8, -(-c // 8) * 8))  # sublane-aligned, ≤ N


def select(gates: torch.Tensor, idx: torch.Tensor, cfg: MoeConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each expert's top-C tokens by gate: (sel_gates [E, C] f32, sel_tok
    [E, C] int64, sel_valid [E, C] bool); an invalid selection (gate 0)
    points at token 0."""
    N = gates.shape[0]
    C = capacity(N, cfg)
    gate_mat = torch.zeros(N, cfg.n_experts, dtype=torch.float32,
                           device=gates.device).scatter(
                               1, idx.long(), gates.float())   # C ≤ N
    sel_gates, sel_tok = _top_k(gate_mat.t(), C)               # [E, C]
    sel_valid = sel_gates > 0.0
    sel_tok = torch.where(sel_valid, sel_tok.clamp_max(N - 1),
                          torch.zeros_like(sel_tok))
    return sel_gates, sel_tok, sel_valid


def dropped(idx: torch.Tensor, sel_tok: torch.Tensor,
            sel_valid: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The (token, expert) assignments of ``route`` that no expert's
    selection kept (a 0-d int64 tensor, on the device)."""
    N = idx.shape[0]
    routed = torch.zeros(N, n_experts, dtype=torch.bool, device=idx.device)
    routed.scatter_(1, idx.long(), True)
    kept = torch.zeros(N + 1, n_experts, dtype=torch.bool, device=idx.device)
    col = torch.where(sel_valid, sel_tok, torch.full_like(sel_tok, N))
    kept.scatter_(0, col.t(), True)
    return (routed & ~kept[:N]).sum()


def _combine(ye: torch.Tensor, idx: torch.Tensor, sel_tok: torch.Tensor,
             sel_valid: torch.Tensor) -> torch.Tensor:
    """y [N, d]: each token's gated expert outputs ``ye`` [E, C, d] summed
    in ascending expert order, one add at ye's dtype at a time (the
    reference's scatter-add order), by gathers only."""
    E, C, d = ye.shape
    N = idx.shape[0]
    # slot[n, e]: the row of ye that holds token n's term from expert e, or
    # E*C (a zero row) where expert e did not keep it; invalid selections
    # write a spare row N that is then dropped
    slot = torch.full((N + 1, E), E * C, dtype=torch.int64, device=ye.device)
    col = torch.where(sel_valid, sel_tok, torch.full_like(sel_tok, N))
    rows = torch.arange(E * C, device=ye.device).view(E, C)
    slot.scatter_(0, col.t(), rows.t())
    experts = torch.sort(idx.long(), dim=1).values                # [N, k]
    terms = torch.cat([ye.reshape(E * C, d), ye.new_zeros(1, d)])[
        slot[:N].gather(1, experts)]                               # [N, k, d]
    y = terms[:, 0]
    for j in range(1, terms.shape[1]):
        y = y + terms[:, j]
    return y


def dispatch_compute(xf: torch.Tensor, router_w: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, cfg: MoeConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_dispatch_compute`` at ``e_lo=0, e_n=E,
    slot_rank=0, n_slots=1``: xf [N, d] → (y [N, d], aux)."""
    gates, idx, aux = route(router_w, xf, cfg)
    sel_gates, sel_tok, sel_valid = select(gates, idx, cfg)
    xg = xf[sel_tok]                                           # [E, C, d]
    xg = torch.where(sel_valid[..., None], xg, torch.zeros_like(xg))
    h = F.silu(torch.bmm(xg, w_gate)) * torch.bmm(xg, w_up)
    ye = torch.bmm(h, w_down)                                  # [E, C, d]
    ye = ye * sel_gates[..., None].to(ye.dtype)
    return _combine(ye, idx, sel_tok, sel_valid), aux


def moe_forward(p: Dict, x: torch.Tensor, cfg: MoeConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, d] → (y [B, L, d], aux · aux_weight). All B·L tokens are
    routed together: they share every expert's capacity."""
    B, L, d = x.shape
    xf = x.reshape(B * L, d)
    y, aux = dispatch_compute(xf, p["router"], p["w_gate"], p["w_up"],
                              p["w_down"], cfg)
    if cfg.n_shared:
        s = p["shared"]
        y = y + blocks.swiglu(s["w_gate"], s["w_up"], s["w_down"], xf)
    return y.reshape(B, L, d), aux * cfg.aux_weight
