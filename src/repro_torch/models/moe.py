"""Mixture-of-Experts: a top-k router and capacity-based dispatch.

Counterpart of ``repro/models/moe.py``. On its meshless path, the one
serving takes (no mesh is set), ``moe_forward`` routes every token of the
call to ``top_k`` experts, each expert takes its top-C tokens by gate
(``capacity``), and a token past an expert's capacity simply loses that
expert's term (no renormalisation). The tokens of one call therefore
compete for capacity: a row's output depends on the other rows of the
same call.

Semantics kept from the reference (the same selections; values within the
rounding of the f32 products):

  * router logits are f32 products of the input and the router; gates are
    cast back to the input's dtype;
  * ``gate_mat`` [N, E] is f32 (``capacity`` keeps C ≤ N; only the
    slot-parallel path's ``C_pad`` may pass N, and then zero rows pad it
    to ``C_pad``, as the reference's do); each expert selects its top C
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
reference.

**Under a mesh** (parallel/sharding.py ``use_mesh``) with a ``model``
axis of M ranks, ``moe_forward`` takes the reference's mesh paths
(``moe.py:168-284``). Each rank holds its own batch rows (its ``pod`` /
``data`` shard) and every rank of a model line the same rows:

  * **EP** (``cfg.ep`` and M divides E): the expert leaves are this rank's
    model shard, ``[E/M, ...]`` (experts r·E/M onward), and the rank
    computes its experts over every token of its rows;
  * **slot-parallel** otherwise (granite's 40 experts; ``ep=False``): the
    expert leaves are whole and rank r takes slot slice r of every
    expert's ``C_pad = ceil(C / M)·M`` capacity slots (``C_pad`` may pass
    C: the reference's rounding, which then drops fewer tokens);
  * either way the routing runs alike on every rank, the rank's work
    enters through ``copy_to`` and the partial outputs are summed over
    the line (in f32, rounded once);
  * **a2a** (``dispatch="a2a"``, EP, and M divides L): the rank takes
    sequence part r of its rows, routes it alone (its own capacity, as
    the reference's shard does), sends each expert's selected rows to the
    expert's owner and the outputs back (two all-to-alls), and the parts
    are gathered back along the sequence;
  * ``aux`` is the mean over the batch ranks (the a2a path's over the
    model ranks too), its gradient the reference's ``_pmean_grad_safe``.

With M = 1 (FSDP data parallelism, train/step.py) a rank's output is the
meshless path's on its rows, bit for bit. Autograd runs through every
collective, so the training step differentiates each path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.parallel import sharding


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
    ep: bool = True              # expert-parallel over 'model' (if divisible)
    dispatch: str = "gather"     # "gather" (psum-EP) | "a2a" (deepseek-style)


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


def leaf_axes(cfg: MoeConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each leaf's logical sharding axes (the reference's ``init_moe``):
    the experts over ``expert`` under ``ep``, else their hidden axis over
    ``mlp_tp``."""
    ex = ("expert", "embed_fsdp", None) if cfg.ep else \
        (None, "embed_fsdp", "mlp_tp")
    ex_out = ("expert", None, "embed_fsdp") if cfg.ep else \
        (None, "mlp_tp", "embed_fsdp")
    out = {"router": ("embed_fsdp", None), "w_gate": ex, "w_up": ex,
           "w_down": ex_out}
    if cfg.n_shared:
        out.update({"shared.w_gate": ("embed_fsdp", "mlp_tp"),
                    "shared.w_up": ("embed_fsdp", "mlp_tp"),
                    "shared.w_down": ("mlp_tp", "embed_fsdp")})
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


def select(gates: torch.Tensor, idx: torch.Tensor, cfg: MoeConfig,
           e_lo: int = 0, e_n: Optional[int] = None, slot_rank: int = 0,
           n_slots: int = 1
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each expert's top tokens by gate, in this rank's slice of the
    (expert, slot) grid: experts ``[e_lo, e_lo + e_n)`` and slots
    ``[slot_rank·C_l, (slot_rank + 1)·C_l)`` of ``C_pad = C_l·n_slots``,
    ``C_l = ceil(C / n_slots)`` → (sel_gates [e_n, C_l] f32, sel_tok
    [e_n, C_l] int64, sel_valid [e_n, C_l] bool); an invalid selection
    (gate 0) points at token 0. The defaults are the whole grid (C_pad =
    C)."""
    N = gates.shape[0]
    e_n = cfg.n_experts if e_n is None else e_n
    C_l = -(-capacity(N, cfg) // n_slots)
    Np = max(N, C_l * n_slots)            # top-k needs k ≤ the rows
    gate_mat = torch.zeros(Np, cfg.n_experts, dtype=torch.float32,
                           device=gates.device).scatter(
                               1, idx.long(), gates.float())
    sel_gates, sel_tok = _top_k(gate_mat.t(), C_l * n_slots)   # [E, C_pad]
    rows = slice(e_lo, e_lo + e_n)
    cols = slice(slot_rank * C_l, (slot_rank + 1) * C_l)
    sel_gates, sel_tok = sel_gates[rows, cols], sel_tok[rows, cols]
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
             sel_valid: torch.Tensor, e_lo: int = 0,
             n_experts: Optional[int] = None) -> torch.Tensor:
    """y [N, d]: each token's gated expert outputs ``ye`` [e_n, C, d]
    (experts ``e_lo`` onward of ``n_experts``, default all of them)
    summed in ascending expert order, one add at ye's dtype at a time (the
    reference's scatter-add order), by gathers only; an expert outside the
    slice, or one that did not keep the token, adds an exact zero."""
    e_n, C, d = ye.shape
    N = idx.shape[0]
    E = e_lo + e_n if n_experts is None else n_experts
    # slot[n, e]: the row of ye that holds token n's term from expert e, or
    # e_n*C (a zero row) where there is none; invalid selections write a
    # spare row N that is then dropped
    slot = torch.full((N + 1, E), e_n * C, dtype=torch.int64,
                      device=ye.device)
    col = torch.where(sel_valid, sel_tok, torch.full_like(sel_tok, N))
    rows = torch.arange(e_n * C, device=ye.device).view(e_n, C)
    slot[:, e_lo:e_lo + e_n] = slot[:, e_lo:e_lo + e_n].scatter(
        0, col.t(), rows.t())
    experts = torch.sort(idx.long(), dim=1).values                # [N, k]
    terms = torch.cat([ye.reshape(e_n * C, d), ye.new_zeros(1, d)])[
        slot[:N].gather(1, experts)]                               # [N, k, d]
    y = terms[:, 0]
    for j in range(1, terms.shape[1]):
        y = y + terms[:, j]
    return y


def _experts(xg: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """[e, c, d] rows through their experts' SwiGLU → [e, c, d]."""
    return torch.bmm(F.silu(torch.bmm(xg, w_gate)) * torch.bmm(xg, w_up),
                     w_down)


def dispatch_compute(xf: torch.Tensor, router_w: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, cfg: MoeConfig, e_lo: int = 0,
                     e_n: Optional[int] = None, slot_rank: int = 0,
                     n_slots: int = 1, line: Optional[sharding.Line] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_dispatch_compute``: xf [N, d] → (this rank's
    partial y [N, d], aux) over experts ``[e_lo, e_lo + e_n)`` (the expert
    leaves hold just those) and slot slice ``slot_rank`` of ``n_slots``
    (:func:`select`); the defaults are the meshless whole grid. ``line``:
    the model line when the slice differs by rank. The routing, alike on
    every rank, stays outside it; the token rows and the gates enter the
    rank's work through ``copy_to``, so their cotangents are summed over
    the line."""
    gates, idx, aux = route(router_w, xf, cfg)
    if line is not None:
        xf, gates = sharding.copy_to(xf, line), sharding.copy_to(gates, line)
    sel_gates, sel_tok, sel_valid = select(gates, idx, cfg, e_lo, e_n,
                                           slot_rank, n_slots)
    xg = xf[sel_tok]                                           # [e_n, C_l, d]
    xg = torch.where(sel_valid[..., None], xg, torch.zeros_like(xg))
    ye = _experts(xg, w_gate, w_up, w_down)
    ye = ye * sel_gates[..., None].to(ye.dtype)
    return _combine(ye, idx, sel_tok, sel_valid, e_lo,
                    cfg.n_experts), aux


def _a2a(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
         w_up: torch.Tensor, w_down: torch.Tensor, cfg: MoeConfig,
         line: sharding.Line) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``local_a2a`` on this rank's sequence part of x [B,
    L, d] (the expert leaves: its EP shard) → (y [B, L/M, d] of that part,
    its aux)."""
    B, Ll, d = x.shape
    M, E = line.size, cfg.n_experts
    Em = E // M
    xl = x.reshape(-1, d)                                     # [N_l, d]
    gates, idx, aux = route(sharding.copy_to(router_w, line), xl, cfg)
    sel_g, sel_t, sel_valid = select(gates, idx, cfg)         # [E, C]
    C = sel_t.shape[1]
    xsend = xl[sel_t.reshape(E * C)].reshape(M, Em * C, d)
    xsend = torch.where(sel_valid.reshape(M, Em * C)[..., None], xsend,
                        torch.zeros_like(xsend))
    # a2a #1: each expert's rows to its owner → [M, Em·C, d]
    xrecv = sharding.all_to_all(xsend, line)
    xg = xrecv.reshape(M, Em, C, d).transpose(0, 1).reshape(Em, M * C, d)
    ye = _experts(xg, w_gate, w_up, w_down)                   # [Em, M·C, d]
    ysend = ye.reshape(Em, M, C, d).transpose(0, 1).reshape(M, Em * C, d)
    # a2a #2: the outputs back to the rows' owners
    yrecv = sharding.all_to_all(ysend, line)
    yrecv = yrecv.reshape(E, C, d) * sel_g[..., None].to(yrecv.dtype)
    return _combine(yrecv, idx, sel_t, sel_valid).reshape(B, Ll, d), aux


def moe_forward(p: Dict, x: torch.Tensor, cfg: MoeConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, d] → (y [B, L, d], aux · aux_weight). Without a mesh all
    B·L tokens are routed together: they share every expert's capacity.
    Under a mesh with a ``model`` axis, the reference's mesh paths (see the
    module docstring): ``x`` is this rank's rows, ``p``'s expert leaves its
    EP shard when the EP path applies."""
    B, L, d = x.shape
    mesh = sharding.current_mesh()
    E = cfg.n_experts
    rw, wg, wu, wd = p["router"], p["w_gate"], p["w_up"], p["w_down"]
    xf = x.reshape(B * L, d)
    if mesh is None or "model" not in mesh.shape:
        y, aux = dispatch_compute(xf, rw, wg, wu, wd, cfg)
    else:
        M = mesh.shape["model"]
        line = mesh.line("model")
        batch_axes = tuple(a for a in sharding.BATCH_AXES if a in mesh.shape)
        ep = cfg.ep and E % M == 0
        held = E // M if ep else E
        if wg.shape[0] != held:
            raise ValueError(f"moe: {E} experts over model = {M} "
                             f"({'EP' if ep else 'slot-parallel'}) hold "
                             f"{held} a rank, got {wg.shape[0]}")
        if cfg.dispatch == "a2a" and ep and L % M == 0:
            y, aux = _a2a(sharding.split_to(x, line, 1), rw, wg, wu, wd,
                          cfg, line)
            y = sharding.gather_from(y, line, 1).reshape(B * L, d)
            over = ("model",) + batch_axes
        else:
            r = line.index
            if not ep:    # whole experts on every rank: their grads sum
                wg, wu, wd = (sharding.copy_to(w, line) for w in (wg, wu, wd))
            y, aux = dispatch_compute(
                xf, rw, wg, wu, wd, cfg, *((r * held, held, 0, 1) if ep
                                           else (0, E, r, M)), line=line)
            y = sharding.reduce_from(y, line)
            over = batch_axes
        if over:
            aux = sharding.pmean(aux, mesh.line(over),
                                 replicated=M if "model" in over else 1)
    if cfg.n_shared:
        s = p["shared"]
        y = y + blocks.swiglu(s["w_gate"], s["w_up"], s["w_down"], xf)
    return sharding.constrain(y.reshape(B, L, d), "batch", None, None), \
        aux * cfg.aux_weight
