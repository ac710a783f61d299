"""Analytic FLOPs / device-memory bytes per (arch × shape): the roofline's
compute and memory terms.

Counterpart of ``repro/launch/accounting.py``, copied over the port's
``ModelConfig`` and ``parse_kind``: the same numbers for every cell. The
dry run (launch/dryrun.py) puts these beside the FLOPs of a traced pass
of the port's own step, which visits every layer (FlopCounterMode counts
what the eager pass issues), so the two cross-check each other.

Conventions: matmul [m,k]×[k,n] = 2mkn flops; backward = 2× forward (train =
3× fwd); causal attention context averaged L/2; MoE counts top_k·capacity_
factor dispatched expert flops (what the capacity path really computes);
bytes model bf16 activations / fp32 optimizer and is deliberately coarse on
activation traffic (±30% — it ranks terms, it does not time kernels).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs import ShapeSpec
from repro_torch.models.transformer import ModelConfig, parse_kind

BF16 = 2
F32 = 4


@dataclasses.dataclass
class Cost:
    flops: float = 0.0           # total fwd(+bwd) flops, whole step, all devices
    hbm_bytes: float = 0.0       # total HBM traffic, whole step, all devices
    model_flops: float = 0.0     # (6 | 2)·N_active·tokens
    params_total: float = 0.0
    params_active: float = 0.0

    def add(self, f=0.0, b=0.0):
        self.flops += f
        self.hbm_bytes += b


# --------------------------------------------------------------------------
# parameter counts (exact, from shapes)
# --------------------------------------------------------------------------
def _attn_params(cfg: ModelConfig) -> float:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    return d * H * hd + 2 * d * K * hd + H * hd * d


def _mla_params(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (cfg.d_model * m.q_lora + m.q_lora * m.n_heads * (m.qk_nope + m.qk_rope)
            + cfg.d_model * m.kv_lora + cfg.d_model * m.qk_rope
            + m.kv_lora * m.n_heads * (m.qk_nope + m.v_dim)
            + m.n_heads * m.v_dim * cfg.d_model)


def _mlp_params(cfg: ModelConfig) -> float:
    mult = 3 if cfg.mlp == "swiglu" else 2
    return mult * cfg.d_model * cfg.d_ff


def _moe_params(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active) — routed experts + shared."""
    mc = cfg.moe
    per_e = 3 * mc.d_model * mc.d_ff
    shared = 3 * mc.d_model * mc.d_ff * mc.n_shared
    router = mc.d_model * mc.n_experts
    total = mc.n_experts * per_e + shared + router
    active = mc.top_k * per_e + shared + router
    return total, active


def _mamba_params(cfg: ModelConfig) -> float:
    m = cfg.mamba
    di, Ns, H = m.d_inner, m.d_state, m.n_heads
    return (cfg.d_model * (2 * di + 2 * Ns + H) + m.conv_k * (di + 2 * Ns)
            + 3 * H + di + di * cfg.d_model)


def _mlstm_params(cfg: ModelConfig) -> float:
    m = cfg.mlstm
    di = m.d_inner
    return (cfg.d_model * 2 * di + m.conv_k * di + 3 * di * di
            + di * 2 * m.n_heads + di + di * cfg.d_model)


def _slstm_params(cfg: ModelConfig) -> float:
    s = cfg.slstm
    d, H, hd = cfg.d_model, s.n_heads, s.head_dim
    f = int(s.ff_factor * d)
    return d * 4 * d + H * hd * 4 * hd + d + d * 2 * f + f * d


def _layer_params(kind: str, cfg: ModelConfig) -> Tuple[float, float]:
    mixer, ffn = parse_kind(kind)
    total = active = 0.0
    if mixer in ("gqa", "local", "global", "enc", "cross"):
        p = _attn_params(cfg)
        total += p
        active += p
    elif mixer == "shared":
        pass  # counted once at top level
    elif mixer == "mla":
        p = _mla_params(cfg)
        total += p
        active += p
    elif mixer == "mamba":
        p = _mamba_params(cfg)
        total += p
        active += p
    elif mixer == "mlstm":
        p = _mlstm_params(cfg)
        total += p
        active += p
    elif mixer == "slstm":
        p = _slstm_params(cfg)
        total += p
        active += p
    if ffn == "mlp":
        p = _mlp_params(cfg)
        total += p
        active += p
    elif ffn == "moe":
        t, a = _moe_params(cfg)
        total += t
        active += a
    return total, active


def param_counts(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active) parameter counts, excluding the input embedding
    (lm_head counted; tied embeddings count once, as the head)."""
    total = active = 0.0
    for pattern, count in tuple(cfg.groups) + tuple(cfg.encoder_groups):
        for kind in pattern:
            t, a = _layer_params(kind, cfg)
            total += count * t
            active += count * a
    if any(parse_kind(k)[0] == "shared" for pat, _ in cfg.groups for k in pat):
        t = _attn_params(cfg) + _mlp_params(cfg)
        total += t
        active += t
    head = cfg.d_model * cfg.vocab
    total += head
    active += head
    if cfg.mtp:
        t, a = _layer_params(cfg.groups[-1][0][-1], cfg)
        total += t + 2 * cfg.d_model * cfg.d_model
        active += a + 2 * cfg.d_model * cfg.d_model
    return total, active


def embed_params(cfg: ModelConfig) -> float:
    return cfg.vocab * cfg.d_model


# --------------------------------------------------------------------------
# per-layer forward flops + activation bytes
# --------------------------------------------------------------------------
def _layer_fwd(kind: str, cfg: ModelConfig, N: float, ctx: float,
               decode: bool) -> Tuple[float, float]:
    """(flops, act_bytes) for N tokens with average attention context ctx."""
    mixer, ffn = parse_kind(kind)
    d = cfg.d_model
    f = b = 0.0
    if mixer in ("gqa", "local", "global", "enc", "cross", "shared"):
        H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        c = min(ctx, cfg.window) if (mixer == "local" and cfg.window) else ctx
        if mixer == "cross":
            c = cfg.encoder_seq
        f += 2 * N * d * (H + 2 * K) * hd + 2 * N * H * hd * d   # projections
        f += 4 * N * c * H * hd                                   # scores+values
        b += N * d * BF16 * 12 + N * (H + 2 * K) * hd * BF16 * 2
        b += N * K * hd * 2 * BF16                                # cache write
        if decode:
            b += N * c * K * hd * 2 * BF16                        # cache read
    elif mixer == "mla":
        m = cfg.mla
        H = m.n_heads
        f += 2 * N * (d * m.q_lora + m.q_lora * H * (m.qk_nope + m.qk_rope)
                      + d * m.kv_lora + d * m.qk_rope)
        if decode:  # absorbed
            f += 2 * N * H * m.qk_nope * m.kv_lora + 2 * N * H * m.kv_lora * m.v_dim
            f += 2 * N * ctx * H * (m.kv_lora + m.qk_rope) + 2 * N * ctx * H * m.kv_lora
            b += N * ctx * (m.kv_lora + m.qk_rope) * BF16         # latent cache read
        else:
            f += 2 * N * m.kv_lora * H * (m.qk_nope + m.v_dim)
            f += 2 * N * ctx * H * (m.qk_nope + m.qk_rope) + 2 * N * ctx * H * m.v_dim
        f += 2 * N * H * m.v_dim * d
        b += N * d * BF16 * 10 + N * (m.kv_lora + m.qk_rope) * BF16 * 2
    elif mixer == "mamba":
        m = cfg.mamba
        di, Ns, H, P, Q = m.d_inner, m.d_state, m.n_heads, m.head_dim, m.chunk
        f += 2 * N * d * (2 * di + 2 * Ns + H) + 2 * N * (di + 2 * Ns) * m.conv_k
        qq = 1 if decode else Q
        f += 2 * N * H * (qq * (Ns + P) + 2 * Ns * P)             # SSD
        f += 2 * N * di * d
        b += N * d * BF16 * 8 + N * di * BF16 * 6
        if decode:
            b += N * H * Ns * P * F32 * 2                         # state r/w
    elif mixer == "mlstm":
        m = cfg.mlstm
        di, H, P, Q = m.d_inner, m.n_heads, m.head_dim, m.chunk
        qq = 1 if decode else Q
        f += 2 * N * d * 2 * di + 2 * N * di * m.conv_k + 6 * N * di * di
        f += 2 * N * H * (qq * (P + P) + 2 * P * P)
        f += 2 * N * di * d
        b += N * d * BF16 * 8 + N * di * BF16 * 8
        if decode:
            b += N * H * P * (P + 1) * F32 * 2
    elif mixer == "slstm":
        s = cfg.slstm
        H, hd = s.n_heads, s.head_dim
        ff = int(s.ff_factor * d)
        f += 2 * N * d * 4 * d + 2 * N * d * 4 * hd
        f += 2 * N * d * 2 * ff + 2 * N * ff * d
        b += N * d * BF16 * 10
    if ffn == "mlp":
        mult = 6 if cfg.mlp == "swiglu" else 4
        f += mult * N * d * cfg.d_ff
        b += N * d * BF16 * 4 + N * cfg.d_ff * BF16 * (3 if cfg.mlp == "swiglu" else 2)
    elif ffn == "moe":
        mc = cfg.moe
        f += 2 * N * d * mc.n_experts                              # router
        f += 6 * N * mc.top_k * mc.capacity_factor * d * mc.d_ff   # dispatched
        f += 6 * N * d * mc.d_ff * mc.n_shared
        b += N * d * BF16 * (6 + 2 * mc.top_k)                     # gather/scatter
    return f, b


def step_cost(cfg: ModelConfig, shape: ShapeSpec) -> Cost:
    """Whole-step analytic cost for one (arch × shape) cell (all devices)."""
    c = Cost()
    total_p, active_p = param_counts(cfg)
    c.params_total, c.params_active = total_p, active_p
    B, L = shape.global_batch, shape.seq_len
    decode = shape.step == "decode"
    N = B * (1 if decode else L)           # tokens through the step
    ctx = L if decode else L / 2           # avg causal context

    for pattern, count in cfg.groups:
        for kind in pattern:
            f, b = _layer_fwd(kind, cfg, N, ctx, decode)
            c.add(count * f, count * b)
    if cfg.encoder_groups and not decode:
        N_enc = B * cfg.encoder_seq
        for pattern, count in cfg.encoder_groups:
            for kind in pattern:
                f, b = _layer_fwd(kind, cfg, N_enc, cfg.encoder_seq / 2, False)
                c.add(count * f, count * b)

    # head (+ MTP) + embed traffic
    c.add(2 * N * cfg.d_model * cfg.vocab,
          N * cfg.vocab * BF16 + N * cfg.d_model * BF16)
    if cfg.mtp and shape.step == "train":
        f, b = _layer_fwd(cfg.groups[-1][0][-1], cfg, N, ctx, False)
        c.add(f + 2 * N * cfg.d_model * cfg.vocab + 4 * N * cfg.d_model ** 2,
              b + N * cfg.vocab * BF16)

    if shape.step == "train":
        c.flops *= 3                                   # fwd + 2×bwd
        c.hbm_bytes *= 3 if cfg.remat == "none" else 4  # remat refetch
        # params + optimizer traffic (ZeRO-sharded totals are the same sum)
        P = total_p + embed_params(cfg)
        c.hbm_bytes += P * (BF16 + F32 * 7)            # bf16 read, grad w,
        #                                               m/v r+w, master r+w
    else:
        P = (total_p if shape.step == "prefill" or
             B * (cfg.moe.top_k if cfg.moe else 1) >= (cfg.moe.n_experts if cfg.moe else 1)
             else active_p)
        c.hbm_bytes += P * BF16 + embed_params(cfg) * BF16 * 0.01

    mult = 6 if shape.step == "train" else 2
    c.model_flops = mult * active_p * N
    return c
