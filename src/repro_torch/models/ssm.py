"""Recurrent mixers: Mamba2 (SSD), the xLSTM's mLSTM and sLSTM.

Counterpart of ``repro/models/ssm.py``, function for function. One chunked
**gated linear attention** core serves Mamba2's SSD and the mLSTM's matrix
memory, the recurrence

    S_t = exp(ld_t)·S_{t-1} + exp(lg_t)·k_t v_tᵀ ,   y_t = q_t·S_t

computed a chunk at a time (:func:`gla_chunked`: scores inside a chunk from
cumulative log-decays, the state carried from chunk to chunk) or a token at
a time (:func:`gla_step`). The sLSTM is a true recurrence, one token after
the other (:func:`slstm_forward`).

The reference computes all of this in plain ``jnp`` (no ``pallas_call`` is
reached), so these are plain PyTorch functions on tensors, on the card as
on the CPU. They hold the reference's rounding points:

  * the gla core casts q, k, v and the log-decays to f32, sums in f32 and
    casts its output back to v's dtype; the state stays f32;
  * Mamba2's log-decay ``dt.float() * A`` and the mLSTM's gate
    pre-activations are f32; the sLSTM's carry (c, n, h) is f32, and its
    recurrent product multiplies the f32 carry by the weights cast to f32
    (JAX promotes the mixed product to f32; bf16 → f32 is exact);
  * :func:`causal_conv` sums its K taps left to right from tap 0;
  * inside a chunk the **exponent** of a masked (s > t) pair is set to
    -1e30 before ``exp``; a ragged last chunk is zero-padded and sliced
    off;
  * the intra-chunk product contracts ``qk·w`` first and then ``v``, so
    no ``[B, t, s, H, P]`` intermediate is made (at xlstm-1.3b's width P
    is 1024).

A state dict (``{"ssm", "conv"}`` for Mamba2 and the mLSTM, ``{"c", "n",
"h"}`` for the sLSTM) makes a forward stepwise: with one token it takes
:func:`gla_step` (``decode = state is not None and L == 1``, a one-token
prompt included), with more it starts :func:`gla_chunked` from it. The
forwards return the new state beside the output and never write the one
they were given; models/transformer.py writes it into the slot caches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models import blocks

NEG = -1e30     # the exponent of a masked pair inside a chunk

# A leaf's init: (shape, std of a normal draw, or one of the fills below)
Leaf = Tuple[Tuple[int, ...], Union[float, str]]
ONES, ZEROS, A_LOG = "ones", "zeros", "log(linspace(1, 16, H))"
F32_LEAVES = ("w_if",)   # drawn in f32 whatever the model's param dtype


# --------------------------------------------------------------------------
# chunked gated linear attention core
# --------------------------------------------------------------------------
def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor,
                log_gate: Optional[torch.Tensor] = None, chunk: int = 128,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [B, L, H, N]; v: [B, L, H, P]; log_decay / log_gate: [B, L, H]
    (ld ≤ 0); state0: [B, H, N, P] or None (zeros).

    Returns (y [B, L, H, P] at v's dtype, final state [B, H, N, P] f32)."""
    B, L, H, N = q.shape
    P = v.shape[-1]
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L
    if log_gate is None:
        log_gate = torch.zeros_like(log_decay)
    if pad:
        def zf(a):      # zero rows after the last on the time axis (1)
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        q, k, v, log_decay, log_gate = (zf(a) for a in
                                        (q, k, v, log_decay, log_gate))
    f32 = torch.float32
    qc = q.reshape(B, nc, Q, H, N).to(f32)
    kc = k.reshape(B, nc, Q, H, N).to(f32)
    vc = v.reshape(B, nc, Q, H, P).to(f32)
    ldc = log_decay.reshape(B, nc, Q, H).to(f32)
    lgc = log_gate.reshape(B, nc, Q, H).to(f32)
    cum = torch.cumsum(ldc, dim=2)                  # Σ_{r≤t} ld_r in a chunk
    tot = cum[:, :, -1]                             # [B, nc, H]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=q.device).tril()
    S = (state0.to(f32) if state0 is not None else
         torch.zeros(B, H, N, P, dtype=f32, device=q.device))
    ys = []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]
        cumb, lgb, totb = cum[:, c], lgc[:, c], tot[:, c]
        # scores[t, s] = (q_t·k_s)·exp(cum_t − cum_s + lg_s), s ≤ t
        expo = cumb[:, :, None] - cumb[:, None] + lgb[:, None]  # [B,t,s,H]
        expo = torch.where(mask[None, :, :, None], expo, NEG)
        w = torch.exp(expo)
        qk = torch.einsum("bthn,bshn->btsh", qb, kb)
        intra = torch.einsum("btsh,bshp->bthp", qk * w, vb)
        cross = torch.einsum("bthn,bhnp->bthp",
                             qb * torch.exp(cumb)[..., None], S)
        # S' = exp(tot)·S + Σ_s exp(tot − cum_s + lg_s)·k_s v_sᵀ
        kw = kb * torch.exp(totb[:, None] - cumb + lgb)[..., None]
        S = torch.exp(totb)[..., None, None] * S + \
            torch.einsum("bshn,bshp->bhnp", kw, vb)
        ys.append(intra + cross)
    y = torch.stack(ys, dim=1).reshape(B, nc * Q, H, P)[:, :L]
    return y.to(v.dtype), S


def gla_step(S: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, log_decay: torch.Tensor,
             log_gate: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: q, k [B, H, N], v [B, H, P], gates [B, H], S [B, H, N, P]
    f32. Returns (y [B, H, P] at v's dtype, S' [B, H, N, P] f32)."""
    f32 = torch.float32
    lg = torch.zeros_like(log_decay) if log_gate is None else log_gate
    kv = torch.einsum("bhn,bhp->bhnp", k.to(f32), v.to(f32))
    S = torch.exp(log_decay.to(f32))[..., None, None] * S + \
        torch.exp(lg.to(f32))[..., None, None] * kv
    y = torch.einsum("bhn,bhnp->bhp", q.to(f32), S)
    return y.to(v.dtype), S


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d: x [B, L, D], w [K, D], state [B, K-1, D]
    (the K-1 inputs before x) or None (zeros). Returns (y [B, L, D], the
    new state, None without one)."""
    K, L = w.shape[0], x.shape[1]
    if state is not None:
        xx = torch.cat([state, x], dim=1)               # [B, K-1+L, D]
        new_state = xx[:, xx.shape[1] - (K - 1):]
    else:
        xx = F.pad(x, (0, 0, K - 1, 0))
        new_state = None
    y = xx[:, 0:L] * w[0]
    for i in range(1, K):
        y = y + xx[:, i:i + L] * w[i]
    return y, new_state


# --------------------------------------------------------------------------
# Mamba2 (SSD)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64            # N
    head_dim: int = 64           # P
    expand: int = 2
    conv_k: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_leaves(cfg: Mamba2Config) -> Dict[str, Leaf]:
    """One Mamba2 layer's leaves (the reference's ``init_mamba2``):
    projections N(0, 1/fan_in), the conv N(0, 1/conv_k), ``A_log`` =
    log(linspace(1, 16, H)), ``D`` ones, ``dt_bias`` zeros, the norm's
    scale ones."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    return {"in_proj": ((d, 2 * di + 2 * N + H), d ** -0.5),  # z x B C dt
            "conv_w": ((cfg.conv_k, di + 2 * N), cfg.conv_k ** -0.5),
            "A_log": ((H,), A_LOG), "D": ((H,), ONES),
            "dt_bias": ((H,), ZEROS), "norm": ((di,), ONES),
            "out_proj": ((di, d), di ** -0.5)}


def _mamba2_qkv(p, x, cfg: Mamba2Config, conv_state=None):
    B, L, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    zxbcdt = x @ p["in_proj"]
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, new_conv = causal_conv(conv_in, p["conv_w"], conv_state)
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                      # [B, L, H]
    A = -torch.exp(p["A_log"].float())                      # [H]
    ld = dt.float() * A                                     # log decay ≤ 0
    xh = xin.reshape(B, L, H, P)
    v = xh * dt[..., None]
    q = Cm[:, :, None].expand(B, L, H, N)
    k = Bm[:, :, None].expand(B, L, H, N)
    return z, xh, q, k, v, ld, new_conv


def mamba2_forward(p, x: torch.Tensor, cfg: Mamba2Config, state=None):
    """x [B, L, d]; state ``{"ssm": [B, H, N, P] f32, "conv": [B, K-1,
    d_inner + 2N]}`` for stepwise use. Returns (out [B, L, d], the new
    state or None)."""
    B, L, _ = x.shape
    decode = state is not None and L == 1
    conv_state = state["conv"] if state is not None else None
    z, xh, q, k, v, ld, new_conv = _mamba2_qkv(p, x, cfg, conv_state)
    if decode:
        y1, S = gla_step(state["ssm"], q[:, 0], k[:, 0], v[:, 0], ld[:, 0])
        y = y1[:, None]
    else:
        S0 = state["ssm"] if state is not None else None
        y, S = gla_chunked(q, k, v, ld, chunk=cfg.chunk, state0=S0)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, L, cfg.d_inner)
    y = blocks.rms_norm(p["norm"], y * F.silu(z))
    out = y @ p["out_proj"]
    new_state = {"ssm": S, "conv": new_conv} if state is not None else None
    return out, new_state


def mamba2_init_state(cfg: Mamba2Config, batch: int, dtype, device=None):
    return {"ssm": torch.zeros(batch, cfg.n_heads, cfg.d_state, cfg.head_dim,
                               dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, cfg.conv_k - 1,
                                cfg.d_inner + 2 * cfg.d_state, dtype=dtype,
                                device=device)}


# --------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MlstmConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2
    conv_k: int = 4
    chunk: int = 128
    gate_clip: float = 12.0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def mlstm_leaves(cfg: MlstmConfig) -> Dict[str, Leaf]:
    """One mLSTM layer's leaves (the reference's ``init_mlstm``): dense
    leaves N(0, 1/fan_in), the conv N(0, 1/conv_k), the norm's scale ones;
    ``w_if`` is drawn in f32 whatever the param dtype (:data:`F32_LEAVES`)."""
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {"up_proj": ((d, 2 * di), d ** -0.5),
            "conv_w": ((cfg.conv_k, di), cfg.conv_k ** -0.5),
            "wq": ((di, di), di ** -0.5), "wk": ((di, di), di ** -0.5),
            "wv": ((di, di), di ** -0.5), "w_if": ((di, 2 * H), di ** -0.5),
            "norm": ((di,), ONES), "down_proj": ((di, d), di ** -0.5)}


def _mlstm_qkv(p, x, cfg: MlstmConfig, conv_state=None):
    B, L, _ = x.shape
    H, P = cfg.n_heads, cfg.head_dim
    up = x @ p["up_proj"]
    xi, z = up.chunk(2, dim=-1)
    conv_out, new_conv = causal_conv(xi, p["conv_w"], conv_state)
    conv_out = F.silu(conv_out)
    q = (conv_out @ p["wq"]).reshape(B, L, H, P) / \
        blocks.rounded(math.sqrt(P), x.dtype)
    k = (conv_out @ p["wk"]).reshape(B, L, H, P)
    v = (xi @ p["wv"]).reshape(B, L, H, P)
    # an f32 w_if (the reference's leaf) promotes xi to f32, as jnp does
    gif = (xi.to(p["w_if"].dtype) @ p["w_if"]).float()
    i_g, f_g = gif.chunk(2, dim=-1)                     # [B, L, H]
    ld = F.logsigmoid(f_g)                              # log forget ≤ 0
    lg = i_g.clamp(-cfg.gate_clip, cfg.gate_clip)       # log input, clipped
    return z, q, k, v, ld, lg, new_conv


def mlstm_forward(p, x: torch.Tensor, cfg: MlstmConfig, state=None):
    """x [B, L, d]; state ``{"ssm": [B, H, P, P+1] f32, "conv": [B, K-1,
    d_inner]}`` for stepwise use. The normaliser rides as an extra value
    column of ones: y = num / max(|den|, 1)."""
    B, L, _ = x.shape
    P = cfg.head_dim
    decode = state is not None and L == 1
    conv_state = state["conv"] if state is not None else None
    z, q, k, v, ld, lg, new_conv = _mlstm_qkv(p, x, cfg, conv_state)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    if decode:
        y1, S = gla_step(state["ssm"], q[:, 0], k[:, 0], v_aug[:, 0],
                         ld[:, 0], lg[:, 0])
        y = y1[:, None]
    else:
        S0 = state["ssm"] if state is not None else None
        y, S = gla_chunked(q, k, v_aug, ld, lg, chunk=cfg.chunk, state0=S0)
    num, den = y[..., :P], y[..., P:]
    y = num / torch.clamp(den.abs(), min=1.0)
    y = y.reshape(B, L, cfg.d_inner)
    y = blocks.rms_norm(p["norm"], y) * F.silu(z)
    out = y @ p["down_proj"]
    new_state = {"ssm": S, "conv": new_conv} if state is not None else None
    return out, new_state


def mlstm_init_state(cfg: MlstmConfig, batch: int, dtype, device=None):
    return {"ssm": torch.zeros(batch, cfg.n_heads, cfg.head_dim,
                               cfg.head_dim + 1, dtype=torch.float32,
                               device=device),
            "conv": torch.zeros(batch, cfg.conv_k - 1, cfg.d_inner,
                                dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# sLSTM (scalar memory, a true recurrence over time)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SlstmConfig:
    d_model: int
    n_heads: int = 4
    ff_factor: float = 4.0 / 3.0
    gate_clip: float = 12.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def slstm_leaves(cfg: SlstmConfig) -> Dict[str, Leaf]:
    """One sLSTM layer's leaves (the reference's ``init_slstm``): dense
    leaves N(0, 1/fan_in), the block-diagonal recurrent weights ``r_gates``
    [H, hd, 4·hd] N(0, 1/hd), the norm's scale ones."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    f = int(cfg.ff_factor * d)
    return {"w_gates": ((d, 4 * d), d ** -0.5),
            "r_gates": ((H, hd, 4 * hd), hd ** -0.5),
            "norm": ((d,), ONES), "ff_up": ((d, 2 * f), d ** -0.5),
            "ff_down": ((f, d), f ** -0.5)}


def slstm_forward(p, x: torch.Tensor, cfg: SlstmConfig, state=None):
    """x [B, L, d]; state ``{"c", "n", "h"}`` [B, H, hd] f32 for stepwise
    use. One step a token: gates from ``x @ w_gates`` plus the f32 carry
    ``h`` through the block-diagonal ``r_gates``."""
    B, L, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    wx = (x @ p["w_gates"]).reshape(B, L, H, 4 * hd)
    r = p["r_gates"].float()
    if state is None:
        z0 = torch.zeros(B, H, hd, dtype=torch.float32, device=x.device)
        c, n, h = z0, z0, z0
    else:
        c, n, h = state["c"], state["n"], state["h"]
    hs = []
    for t in range(L):
        rh = torch.einsum("bhd,hde->bhe", h, r)
        g = (wx[:, t] + rh).float()
        zt, it, ft, ot = g.chunk(4, dim=-1)
        zt = torch.tanh(zt)
        it = torch.exp(it.clamp(-cfg.gate_clip, cfg.gate_clip))
        ft = torch.sigmoid(ft)
        ot = torch.sigmoid(ot)
        c = ft * c + it * zt
        n = ft * n + it
        h = ot * (c / torch.clamp(n.abs(), min=1.0))
        hs.append(h.to(x.dtype))
    y = torch.stack(hs, dim=1).reshape(B, L, d)
    y = blocks.rms_norm(p["norm"], y)
    u, gate = (y @ p["ff_up"]).chunk(2, dim=-1)
    out = (F.gelu(u, approximate="tanh") * gate) @ p["ff_down"]
    new_state = None if state is None else {"c": c, "n": n, "h": h}
    return out, new_state


def slstm_init_state(cfg: SlstmConfig, batch: int, device=None):
    return {name: torch.zeros(batch, cfg.n_heads, cfg.head_dim,
                              dtype=torch.float32, device=device)
            for name in ("c", "n", "h")}


# --------------------------------------------------------------------------
# dispatch by mixer kind (models/transformer.py)
# --------------------------------------------------------------------------
RECURRENT = ("mamba", "mlstm", "slstm")
FORWARD = {"mamba": mamba2_forward, "mlstm": mlstm_forward,
           "slstm": slstm_forward}
LEAVES = {"mamba": mamba2_leaves, "mlstm": mlstm_leaves,
          "slstm": slstm_leaves}
# each leaf's logical sharding axes, as the reference's ``init_*`` name them
# (models/transformer.py ``param_axes``)
AXES = {
    "mamba": {"in_proj": ("embed_fsdp", "heads_tp"),
              "conv_w": (None, "heads_tp"), "A_log": ("heads_tp",),
              "D": ("heads_tp",), "dt_bias": ("heads_tp",),
              "norm": ("heads_tp",), "out_proj": ("heads_tp", "embed_fsdp")},
    "mlstm": {"up_proj": ("embed_fsdp", "heads_tp"),
              "conv_w": (None, "heads_tp"), "wq": ("heads_tp", None),
              "wk": ("heads_tp", None), "wv": ("heads_tp", None),
              "w_if": ("heads_tp", None), "norm": ("heads_tp",),
              "down_proj": ("heads_tp", "embed_fsdp")},
    "slstm": {"w_gates": ("embed_fsdp", "heads_tp"),
              "r_gates": ("heads_tp", None, None), "norm": (None,),
              "ff_up": ("embed_fsdp", "mlp_tp"),
              "ff_down": ("mlp_tp", "embed_fsdp")}}
