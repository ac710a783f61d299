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

**On one rank of a mesh** (the serving steps on a rank's shards:
models/transformer.py ``hidden`` passes each forward its leaves' specs
and its state's, ``spec`` / ``cache_spec``) a forward reads what the rank
holds of every leaf through ``sharding.held``; with no spec or no mesh
that is the whole dimension, and the same ops run on the whole leaves.

  * The heads: those of the rank's part of the state (``ssm``, or the
    sLSTM's ``c``; all of them where the state is whole, the same on every
    rank of the line). The gla core (:func:`gla_chunked` /
    :func:`gla_step`) and the sLSTM's recurrence run on them alone, and
    the new state is the rank's part.
  * A fused projection cut by columns (Mamba2's ``in_proj``, z | x | B |
    C | dt; the mLSTM's ``up_proj``, xi | z) is cut across its parts, so
    a rank's columns do not fall on its heads: its output is gathered
    whole over the line (one all-gather of [B, L, width]). The causal
    conv then runs on every channel, its weights and history gathered
    whole where they are cut (small), and the new history is cut back to
    the rank's channels. Mamba2's B and C, shared by every head, are
    whole so.
  * A projection cut by rows (the mLSTM's ``wq`` / ``wk`` / ``wv`` /
    ``w_if``, ``out_proj`` / ``down_proj``, the sLSTM's ``ff_down``)
    takes the rank's rows of its input and gives a partial product,
    summed in f32 over the line (``reduce_from``); the mLSTM's input
    projections form their partial products in f32 too, so that the
    gates and q / k / v the recurrence reads round once, as one rank's.
  * A norm over the whole inner row whose rank holds some heads' channels
    sums the squares over the heads' line (one all-reduce of [B, L, 1]
    f32), and scales the channels the output projection's rows take.
  * The sLSTM's ``w_gates`` (cut by columns off its heads' boundaries),
    ``r_gates`` and ``ff_up`` (u | g) give the rank's heads and hidden
    rows through ``sharding.take``: sliced where held, gathered over the
    line where not.

**The training forward on a rank's shards** (no state: models/
transformer.py ``_train_layer`` passes each forward its leaves' specs)
runs the same steps under autograd, with the collectives' gradients of
parallel/sharding.py. Mamba2's and the mLSTM's heads are those whose
channels cover the output projection's rows (a rank may hold part of a
head: the ranks that share it each run it, and the norm then sums its
squares over the rows' channels alone); the sLSTM's are those of its
``r_gates``. Work that differs by rank of the output projection's line
(:func:`_enter`) takes ``x`` and every leaf whole on the line through
``copy_to``, every gather ``apart`` (``gather_shards``: the cotangents
summed and scattered) and every partial sum read by heads through
``reduce_from(..., apart=True)``; work the ranks run alike takes a
column cut through ``copy_to`` on its input and ``gather_from``
(:func:`_project`), a row cut through ``copy_to`` and ``reduce_from``.
The sLSTM's heads and its MLP are two such spans: the heads' differs by
rank where the heads or the MLP's rows are cut, the MLP's where its rows
are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.parallel import sharding

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
# one rank of a mesh: what the forwards read of their leaves' specs
# --------------------------------------------------------------------------
def _held(p, spec, name: str, dim: int) -> sharding.Held:
    """What this rank holds of dimension ``dim`` of leaf ``name``."""
    return sharding.held(p[name], spec.get(name), dim,
                         sharding.current_mesh())


def _heads(state, name: str, cache_spec, mesh) -> sharding.Held:
    """The heads a rank runs in a serving step: those of its part of the
    state leaf ``name`` (axis 1)."""
    return sharding.held(state[name], (cache_spec or {}).get(name), 1, mesh)


def _channels(heads: sharding.Held, width: int, whole: int
              ) -> sharding.Held:
    """The channels of ``heads`` (``width`` a head) out of ``whole``."""
    return heads._replace(lo=heads.lo * width, hi=heads.hi * width,
                          whole=whole)


def _enter(p, spec, names, x: Optional[torch.Tensor],
           line: Optional[sharding.Line]):
    """The training forward's entry into work that differs by rank of
    ``line`` (None: none does; ``p`` and ``x`` as they are): ``x`` and
    each leaf of ``names`` whole on the line through ``copy_to`` over it,
    since a rank uses only its part of each and their cotangents are the
    line's sum (parallel/sharding.py's module docstring). Inside, every
    gather is ``apart`` and every partial sum read by heads
    ``reduce_from(..., apart=True)``."""
    if line is None:
        return p, x
    p = dict(p)
    for name in names:
        if all(_held(p, spec, name, d).line is None
               for d in range(p[name].dim())):
            p[name] = sharding.copy_to(p[name], line)
    return p, None if x is None else sharding.copy_to(x, line)


def _project(a: torch.Tensor, w: torch.Tensor, cols: sharding.Held,
             *spans: Tuple[int, int], apart: bool = False):
    """The ranges ``spans`` of the columns of ``a @ w``, ``w`` holding
    ``cols`` of them (``sharding.take``). Work the ranks run alike
    (``apart`` False) enters a column cut through ``copy_to`` on ``a``:
    each rank's product holds only its columns' share of a's gradient."""
    if cols.line is not None and not apart:
        a = sharding.copy_to(a, cols.line)
    return sharding.take(a @ w, cols, *spans, apart=apart)


def _conv(p, spec, xc: torch.Tensor, state, cache_spec, apart=False):
    """SiLU of :func:`causal_conv` of the whole channels ``xc`` [B, L, D]
    over ``p["conv_w"]`` and the history ``state["conv"]`` (none without a
    state), each gathered whole where the rank holds a part, and the new
    history cut back to the rank's channels (None without a state)."""
    cw = _held(p, spec, "conv_w", 1)
    w = sharding.take(p["conv_w"], cw, (0, cw.whole), apart=apart)[0]
    if state is None:
        return F.silu(causal_conv(xc, w)[0]), None
    hist = state["conv"]
    ch = sharding.held(hist, (cache_spec or {}).get("conv"), 2,
                       sharding.current_mesh())
    y, new = causal_conv(xc, w, sharding.take(hist, ch, (0, ch.whole))[0])
    return F.silu(y), new[..., ch.lo:ch.hi]


def _rows_out(p, spec, name: str, y: torch.Tensor, yc: sharding.Held,
              nc: sharding.Held, z: Optional[torch.Tensor] = None,
              apart: bool = False) -> torch.Tensor:
    """The output projection ``p[name]`` of the normed inner row: ``y``
    holds its channels ``yc`` (the ranks of ``yc.line`` the rest; gathered
    whole first where they lack ``p[name]``'s rows), the norm's scale its
    part ``nc``; ``blocks.rms_norm``, over the row's parts on ``yc.line``
    (each rank's channels of ``p[name]``'s rows), of the channels of
    ``p[name]``'s rows (times SiLU of the whole gate ``z``'s, the
    mLSTM's), times those rows, summed over their line. ``apart``: the
    training forward's gathers inside work that differs by rank."""
    oc = _held(p, spec, name, 0)
    if not (yc.lo <= oc.lo and oc.hi <= yc.hi):
        y = sharding.take(y, yc, (0, yc.whole), apart=apart)[0]
        yc = sharding.Held(0, yc.whole, yc.whole, None)
    lo, hi = (oc.lo, oc.hi) if yc.line is not None else (yc.lo, yc.hi)
    scale = sharding.take(p["norm"], nc, (lo, hi), dim=0, apart=apart)[0]
    y = blocks.rms_norm(scale, y[..., lo - yc.lo:hi - yc.lo],
                        line=yc.line)[..., oc.lo - lo:oc.hi - lo]
    if z is not None:
        y = y * F.silu(z[..., oc.lo:oc.hi])
    out = y @ p[name]
    return out if oc.line is None else sharding.reduce_from(out, oc.line)


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


def mamba2_forward(p, x: torch.Tensor, cfg: Mamba2Config, state=None,
                   spec=None, cache_spec=None):
    """x [B, L, d]; state ``{"ssm": [B, H, N, P] f32, "conv": [B, K-1,
    d_inner + 2N]}`` for stepwise use. Returns (out [B, L, d], the new
    state or None). On one rank of a mesh (``spec`` / ``cache_spec``: the
    leaves' and the state's specs) the rank's heads, as the module
    docstring sets out."""
    B, L, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    spec = spec or {}
    heads, p, x = _plan(p, spec, x, state, cache_spec, "out_proj", P, H)
    h_lo, h_hi = heads.lo, heads.hi
    apart = state is None and heads.line is not None
    ic = _held(p, spec, "in_proj", 1)
    zxbcdt = _project(x, p["in_proj"], ic, (0, ic.whole), apart=apart)[0]
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    conv_out, new_conv = _conv(p, spec, torch.cat([xin, Bm, Cm], dim=-1),
                               state, cache_spec, apart)
    xin, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    dt_bias, A_log, D = (sharding.take(p[k], _held(p, spec, k, 0),
                                       (h_lo, h_hi), dim=0, apart=apart)[0]
                         for k in ("dt_bias", "A_log", "D"))
    dt = F.softplus(dt[..., h_lo:h_hi] + dt_bias)           # [B, L, Hc]
    A = -torch.exp(A_log.float())                           # [Hc]
    ld = dt.float() * A                                     # log decay ≤ 0
    Hc = h_hi - h_lo
    xh = xin[..., h_lo * P:h_hi * P].reshape(B, L, Hc, P)
    v = xh * dt[..., None]
    q = Cm[:, :, None].expand(B, L, Hc, N)
    k = Bm[:, :, None].expand(B, L, Hc, N)
    if state is not None and L == 1:                        # decode
        y1, S = gla_step(state["ssm"], q[:, 0], k[:, 0], v[:, 0], ld[:, 0])
        y = y1[:, None]
    else:
        S0 = state["ssm"] if state is not None else None
        y, S = gla_chunked(q, k, v, ld, chunk=cfg.chunk, state0=S0)
    y = y + xh * D[None, None, :, None]
    y = y.reshape(B, L, Hc * P) * F.silu(z[..., h_lo * P:h_hi * P])
    out = _rows_out(p, spec, "out_proj", y, _channels(heads, P, di),
                    _held(p, spec, "norm", 0), apart=apart)
    new_state = {"ssm": S, "conv": new_conv} if state is not None else None
    return out, new_state


def _plan(p, spec, x: torch.Tensor, state, cache_spec, out: str,
          width: int, H: int):
    """(heads, p, x) for Mamba2 / the mLSTM: in a serving step the heads
    of the rank's state; in the training forward (no state) those whose
    channels (``width`` a head) cover the output projection ``out``'s
    rows, over its line (a rank may hold part of a head, and the ranks
    that share it each run it; all H with the rows whole), ``x`` and the
    leaves whole on that line entered through :func:`_enter`."""
    if state is not None:
        return (_heads(state, "ssm", cache_spec, sharding.current_mesh()),
                p, x)
    oc = _held(p, spec, out, 0)
    heads = sharding.Held(oc.lo // width, -(-oc.hi // width), H, oc.line) \
        if oc.line is not None else sharding.Held(0, H, H, None)
    return (heads,) + _enter(p, spec, tuple(p), x, heads.line)


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


def mlstm_forward(p, x: torch.Tensor, cfg: MlstmConfig, state=None,
                  spec=None, cache_spec=None):
    """x [B, L, d]; state ``{"ssm": [B, H, P, P+1] f32, "conv": [B, K-1,
    d_inner]}`` for stepwise use. The normaliser rides as an extra value
    column of ones: y = num / max(|den|, 1). On one rank of a mesh, as
    :func:`mamba2_forward`."""
    B, L, _ = x.shape
    H, P, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    spec = spec or {}
    heads, p, x = _plan(p, spec, x, state, cache_spec, "down_proj", P, H)
    h_lo, h_hi = heads.lo, heads.hi
    Hc = h_hi - h_lo
    apart = state is None and heads.line is not None
    uc = _held(p, spec, "up_proj", 1)
    up = _project(x, p["up_proj"], uc, (0, uc.whole), apart=apart)[0]
    xi, z = up.chunk(2, dim=-1)
    conv_out, new_conv = _conv(p, spec, xi, state, cache_spec, apart)

    def proj(a, name):    # a @ p[name], p[name]'s rows of di, the whole sum
        c = _held(p, spec, name, 0)
        if c.line is None:
            return a @ p[name]
        if not apart:     # a row cut in work the ranks run alike
            a = sharding.copy_to(a, c.line)
        # the partial products in f32, rounded once after the sum, as the
        # one-rank product rounds once: the recurrence amplifies a rounding
        # of each part (bf16 parts doubled 10d's xlstm rank error)
        y = a[..., c.lo:c.hi].float() @ p[name].float()
        return sharding.reduce_from(y, c.line, apart=apart).to(a.dtype)

    def mine(a):          # [B, L, H·w] → the rank's heads [B, L, Hc, w]
        return a.reshape(B, L, H, -1)[:, :, h_lo:h_hi]

    q = mine(proj(conv_out, "wq")) / blocks.rounded(math.sqrt(P), x.dtype)
    k = mine(proj(conv_out, "wk"))
    v = mine(proj(xi, "wv"))
    # an f32 w_if (the reference's leaf) promotes xi to f32, as jnp does
    gif = proj(xi.to(p["w_if"].dtype), "w_if").float()
    i_g, f_g = (g[..., h_lo:h_hi] for g in gif.chunk(2, dim=-1))  # [B,L,Hc]
    ld = F.logsigmoid(f_g)                              # log forget ≤ 0
    lg = i_g.clamp(-cfg.gate_clip, cfg.gate_clip)       # log input, clipped
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    if state is not None and L == 1:                    # decode
        y1, S = gla_step(state["ssm"], q[:, 0], k[:, 0], v_aug[:, 0],
                         ld[:, 0], lg[:, 0])
        y = y1[:, None]
    else:
        S0 = state["ssm"] if state is not None else None
        y, S = gla_chunked(q, k, v_aug, ld, lg, chunk=cfg.chunk, state0=S0)
    num, den = y[..., :P], y[..., P:]
    y = (num / torch.clamp(den.abs(), min=1.0)).reshape(B, L, Hc * P)
    out = _rows_out(p, spec, "down_proj", y, _channels(heads, P, di),
                    _held(p, spec, "norm", 0), z, apart)
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


def slstm_forward(p, x: torch.Tensor, cfg: SlstmConfig, state=None,
                  spec=None, cache_spec=None):
    """x [B, L, d]; state ``{"c", "n", "h"}`` [B, H, hd] f32 for stepwise
    use. One step a token: gates from ``x @ w_gates`` plus the f32 carry
    ``h`` through the block-diagonal ``r_gates``. On one rank of a mesh,
    as :func:`mamba2_forward`: the heads of the rank's carry (in the
    training forward, those of its ``r_gates``), then the whole h for the
    norm, the MLP column- and row-parallel as the leaves are cut. Under
    autograd the heads and the MLP are two spans of work: the heads' span
    differs by rank where the heads or the MLP's rows are cut, the MLP's
    where its rows are, and each enters through :func:`_enter`."""
    B, L, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    mesh, spec = sharding.current_mesh(), spec or {}
    fr = _held(p, spec, "ff_down", 0)       # the rank's rows of the hidden
    if state is None:
        heads = _held(p, spec, "r_gates", 0)
        mlp = fr.line                       # the MLP's span differs by rank
        p, x = _enter(p, spec, ("w_gates", "r_gates"), x, heads.line or mlp)
        p = _enter(p, spec, ("norm", "ff_up"), None, mlp)[0]
    else:
        heads, mlp = _heads(state, "c", cache_spec, mesh), None
    h_lo, h_hi = heads.lo, heads.hi
    Hc = h_hi - h_lo
    apart = (heads.line or mlp) is not None
    wx = _project(x, p["w_gates"], _held(p, spec, "w_gates", 1),
                  (h_lo * 4 * hd, h_hi * 4 * hd), apart=apart)[0]
    wx = wx.reshape(B, L, Hc, 4 * hd)
    r = sharding.take(p["r_gates"], _held(p, spec, "r_gates", 0),
                      (h_lo, h_hi), dim=0, apart=apart)[0].float()
    if state is None:
        z0 = torch.zeros(B, Hc, hd, dtype=torch.float32, device=x.device)
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
    # the norm reads the whole row: the heads' channels gathered
    apart = mlp is not None
    y = sharding.take(torch.stack(hs, dim=1).reshape(B, L, Hc * hd),
                      _channels(heads, hd, d), (0, d), apart=apart)[0]
    norm = sharding.take(p["norm"], _held(p, spec, "norm", 0), (0, d),
                         dim=0, apart=apart)[0]
    y = blocks.rms_norm(norm, y)
    f = fr.whole
    u, gate = _project(y, p["ff_up"], _held(p, spec, "ff_up", 1),
                       (fr.lo, fr.hi), (f + fr.lo, f + fr.hi), apart=apart)
    out = (F.gelu(u, approximate="tanh") * gate) @ p["ff_down"]
    if fr.line is not None:
        out = sharding.reduce_from(out, fr.line)
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
