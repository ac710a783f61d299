"""Model blocks on torch tensors: RMS norm, rotary embedding, SwiGLU, embedding.

Counterpart of ``repro/models/blocks.py`` for the blocks the paged serving
path runs. Numerics follow the reference: the norm and the rotary angles
are computed in float32 and cast back to the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """``x / sqrt(mean(x²) + eps) · scale`` in float32, cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = scale.float()
    if zero_centered:           # gemma convention: scale stored as (1 + s)
        s = 1.0 + s
    return (y * s).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Half-split rotary embedding. x: [..., seq, heads, hd]; positions:
    [..., seq] int. The first and second halves of hd form the pairs (not
    interleaved even/odd lanes); angles are float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)                # [hd/2]
    ang = positions.float()[..., None] * freqs                    # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]                            # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def embed_lookup(table: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Row gather: [vocab, d] × int ids [...] → [..., d]."""
    return F.embedding(token_ids.long(), table)
