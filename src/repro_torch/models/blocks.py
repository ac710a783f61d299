"""Model blocks on torch tensors: norms, rotary embedding, MLPs, embedding.

Counterpart of ``repro/models/blocks.py`` for the blocks the port runs.
Numerics follow the reference: the norms and the rotary angles are
computed in float32 and cast back to the input dtype; the GELU is the tanh
approximation (``jax.nn.gelu(approximate=True)``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import addrspace
from repro_torch.parallel import sharding


@functools.lru_cache(maxsize=None)
def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` first, as JAX rounds a Python scalar
    (``jnp.asarray(value, dtype)``, or a weak-typed scalar meeting an array
    of that dtype): the product or quotient with it is then one rounding,
    as in the reference."""
    return float(torch.tensor(value, dtype=dtype))


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False,
             line: Optional[sharding.Line] = None) -> torch.Tensor:
    """``x / sqrt(mean(x²) + eps) · scale`` in float32, cast back to x's
    dtype. With a ``line`` (parallel/sharding.py) x and ``scale`` are this
    rank's equal part of the row, the line's other ranks hold the rest:
    the sum of squares is summed over it (one all-reduce of [..., 1]).
    Each rank scales only its own channels by it, so under autograd its
    cotangent is summed over the line too (``reduce_from(...,
    apart=True)``)."""
    x32 = x.float()
    if line is None:
        var = x32.square().mean(dim=-1, keepdim=True)
    else:
        var = sharding.reduce_from(x32.square().sum(dim=-1, keepdim=True),
                                   line, apart=True) / (x.shape[-1] *
                                                        line.size)
    y = x32 * torch.rsqrt(var + eps)
    s = scale.float()
    if zero_centered:           # gemma convention: scale stored as (1 + s)
        s = 1.0 + s
    return (y * s).to(x.dtype)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) · scale + bias`` in float32 (the
    variance about the mean, biased), cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


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


def relu2_mlp(w_in: torch.Tensor, w_out: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Squared-ReLU MLP (nemotron / minitron): ``relu(x @ w_in)² @ w_out``."""
    return torch.square(F.relu(x @ w_in)) @ w_out


def gelu_mlp(w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
             b_out: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """GELU MLP with biases (whisper): ``gelu(x @ w_in + b_in) @ w_out +
    b_out``, the tanh approximation as the reference's (``b_out`` None:
    no output bias, for a partial product that is summed first)."""
    y = F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out
    return y if b_out is None else y + b_out


def embed_lookup(table: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Row gather: [vocab, d] × int ids [...] → [..., d], legalized as
    core/addrspace.py says (row ids int32: NATIVE for every vocab)."""
    return addrspace.legalized_take(table, token_ids, axis=0)
