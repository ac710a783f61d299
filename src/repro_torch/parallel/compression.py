"""Gradient compression with error feedback.

Counterpart of ``repro/parallel/compression.py``. The reference applies
the compressor to the gradients inside ``train_step``, before the
optimizer (train/step.py does the same); under a data-parallel mesh it is
what shrinks the all-reduce's operand. ``bf16`` rounds every gradient to
bfloat16 and back; ``int8`` quantizes it in blocks of ``block`` elements
(the flat leaf zero-padded to whole blocks), each block scaled by its
largest magnitude / 127 and rounded half to even, then dequantizes it.
:func:`with_error_feedback` carries the rounding error into the next
step's gradient (e ← (g + e) − Q(g + e)).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tree as tree_lib


@dataclasses.dataclass
class Compressor:
    """Callable: a gradient tree → the tree quantized and dequantized (a
    None leaf stays None)."""
    mode: str = "bf16"          # "bf16" | "int8" | "none"
    block: int = 256            # int8 block-quant group size

    def __call__(self, grads):
        if self.mode == "none":
            return grads
        return tree_lib.tree_map(self._q, grads)

    def _q(self, g):
        if g is None:
            return None
        if self.mode == "bf16":
            return g.to(torch.bfloat16).float()
        if self.mode == "int8":
            q, scale = quantize_int8(g, self.block)
            return dequantize_int8(q, scale, g.shape)
        return g


def quantize_int8(g: torch.Tensor, block: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8: (q [n_blocks, block] int8, scale
    [n_blocks, 1] f32), scale = max|g| in the block / 127."""
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blk = flat.reshape(-1, block).float()
    scale = blk.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blk / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def with_error_feedback(compress_fn, grads, residual):
    """corrected = g + e; out = Q(corrected); e' = corrected − out."""
    corrected = tree_lib.tree_map(torch.add, grads, residual)
    out = compress_fn(corrected)
    new_resid = tree_lib.tree_map(torch.sub, corrected, out)
    return out, new_resid


def init_residual(params):
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
