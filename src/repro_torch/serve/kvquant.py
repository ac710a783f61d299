"""Quantized KV pages: int8 payload + per-page per-kv-head float32 scales.

Counterpart of ``repro/serve/kvquant.py``. Pages are stored at int8 with
one absmax scale per (page, kv head) and dequantized inside the attention
kernels (int8 × scale, f32 accumulation), so the pool holds a quarter of
an f32 pool's bytes (half of a bf16 pool's) while the page-table machinery
(vmm identity, COW forks, prefix sharing) is untouched: the scales are two
more pool leaves riding the same pages.

This module is the one place the quantization math lives; the scatters of
serve/paged_step.py call these helpers. Everything runs in f32, with the
reference's order of operations, so the port's pools and scales equal the
reference's bit for bit (``torch.round`` rounds half to even, as
``jnp.round`` does).

Layout & invariants:

  * Pool leaves per layer position: ``{"k","v"}`` int8 [count, P, K, pt, hd]
    plus ``{"k_scale","v_scale"}`` f32 [count, P, K]. A value dequantizes as
    ``q * scale``; ``scale = absmax / 127`` over the page's (pt, hd) rows.
  * **Scales are page state**: zeroed when a page is (re-)allocated
    (``PagedCachePool.reset_pages``), copied by COW forks, and shared by the
    prefix layer exactly like the int8 rows they describe.
  * **Monotone-max incremental writes**: a write of new rows sets
    ``scale' = max(scale, absmax(new)/127)`` and requantizes the page's
    existing rows by ``scale/scale'`` in the same step. When the scale is
    unchanged the ratio is exactly 1.0 and ``round(q · 1.0) == q``, so
    repeated writes never drift.
  * ``scale == 0`` means "page holds no information": it quantizes to 0
    and the rescale ratio is 0.
"""
from __future__ import annotations

import torch

# int8 symmetric range; 127 (not 128) so the grid is symmetric and the
# clip can never overflow the dtype
Q_MAX = 127.0

INT8 = "int8"
COMPUTE = "compute"
KV_DTYPES = (COMPUTE, INT8)

# pool-leaf names: payload rows and their scale rows
PAYLOAD = ("k", "v")
SCALE_OF = {"k": "k_scale", "v": "v_scale"}


def validate_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return kv_dtype


def abs_scale(rows: torch.Tensor) -> torch.Tensor:
    """rows [..., K, pt, hd] → scale [..., K]: the absmax over the token and
    feature axes, divided by ``Q_MAX``, in f32."""
    return rows.float().abs().amax(dim=(-2, -1)) / Q_MAX


def quantize(rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """rows [..., K, pt, hd] at scale [..., K] → int8 [..., K, pt, hd].
    ``scale == 0`` (an all-zero or never-written page) quantizes to 0."""
    safe = torch.where(scale > 0, scale, 1.0)[..., None, None]
    q = rows.float() / safe
    return torch.round(q).clamp(-Q_MAX, Q_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 [..., K, pt, hd] × scale [..., K] → f32 rows."""
    return q.float() * scale[..., None, None]


def quantize_pages(rows: torch.Tensor):
    """Full-page quantize: rows [..., K, pt, hd] → (int8 rows, f32 scale
    [..., K]). A chunk scatter that covers a whole fresh page writes the
    same bytes through the same pair of helpers."""
    scale = abs_scale(rows)
    return quantize(rows, scale), scale


def rescale_ratio(old_scale: torch.Tensor,
                  new_scale: torch.Tensor) -> torch.Tensor:
    """``old/new`` (exactly 1.0 when unchanged), 0 where the new scale is 0."""
    safe = torch.where(new_scale > 0, new_scale, 1.0)
    return torch.where(new_scale > 0, old_scale / safe, 0.0)


def requantize(q: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """Apply a rescale ratio [..., K] to int8 content [..., K, pt, hd]."""
    r = q.float() * ratio[..., None, None]
    return torch.round(r).clamp(-Q_MAX, Q_MAX).to(torch.int8)
