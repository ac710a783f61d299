"""Index-width promotion analysis (the part the page allocator needs).

Counterpart of ``repro/core/addrspace.py``'s static analysis: a flat element
index or byte offset over a shape stays 32-bit when it provably fits, and is
promoted to 64-bit otherwise.
"""
from __future__ import annotations

from typing import Sequence

import torch

INT32_MAX = 2**31 - 1


def flat_size(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def needs_promotion(shape: Sequence[int], itemsize: int = 1) -> bool:
    """True iff a flat *element* index (itemsize=1) or *byte* offset
    (itemsize=dtype bytes) over ``shape`` can exceed int32 range."""
    return flat_size(shape) * itemsize > INT32_MAX


def index_dtype(shape: Sequence[int], itemsize: int = 1) -> torch.dtype:
    """Provably-32-bit indices stay int32; anything wider is int64."""
    return torch.int64 if needs_promotion(shape, itemsize) else torch.int32
