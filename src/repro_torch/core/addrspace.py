"""Mixed-data-model index legalization (HEROv2 §2.2.1) on the card.

Counterpart of ``repro/core/addrspace.py``. The paper's problem: a 32-bit
accelerator must hold 64-bit *host* pointers. Its solution: an extra
address space so 64-bit pointers are representable, a *promotion
analysis* that keeps every pointer provably within 32 bits native, and a
*legalizer* that lowers wider accesses through the address-extension CSR.
On the card the native index is int32 as on the TPU (int64 integer
arithmetic is emulated with two or more instructions); the "64-bit host
address" is a flat element offset into a logical array, which overflows
int32 once ``prod(shape) >= 2**31`` (gemma3-27b's f32 embedding as byte
offsets; a [batch·seq, vocab] logit block at 32k context).

  * :func:`index_dtype` / :func:`needs_promotion` / :func:`address_space`
    — the static analysis;
  * :class:`Addr64` + :func:`split64` / :func:`combine32` — the (hi, lo)
    int32-pair form (the paper's CSR holds the hi word);
  * :func:`legalized_take` — a row gather whose indices stay int32
    whenever the analysis proves they can (the embedding's lookup,
    models/blocks.py ``embed_lookup``);
  * :func:`legalized_flat_gather` — the general 64-bit flat gather,
    decomposed into int32 row / column arithmetic.

PyTorch has no unsigned 32-bit arithmetic, so every operation here stays
within *signed* int32 without overflow: :meth:`Addr64.add` adds 16-bit
halves, and the long division's 16-bit limbs keep each partial value
below 2^31, which needs the divisor C < 2^15 (the reference's unsigned
limbs take C < 2^16; :func:`legal_flat_gather_possible` says which).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1
NATIVE = "native32"  # accelerator address space
HOST = "host64"      # promoted address space


# --------------------------------------------------------------------------
# promotion analysis (static, shape-level)
# --------------------------------------------------------------------------
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


def address_space(shape: Sequence[int], itemsize: int = 1) -> str:
    return HOST if needs_promotion(shape, itemsize) else NATIVE


# --------------------------------------------------------------------------
# (hi, lo) int32-pair arithmetic — the address-extension-CSR representation
# --------------------------------------------------------------------------
_LO16 = 0xFFFF


def _halves(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unsigned high and low 16 bits of each int32 word, as int32."""
    return (x >> 16) & _LO16, x & _LO16


def _word(hi16: torch.Tensor, lo16: torch.Tensor) -> torch.Tensor:
    """The int32 word of two 16-bit halves (bit 31 from the high half)."""
    sign = hi16 >= 0x8000
    return torch.where(sign, (hi16 - 0x10000) * 0x10000, hi16 * 0x10000) \
        | lo16


@dataclasses.dataclass
class Addr64:
    """A 64-bit logical address held as two int32 words (hi = CSR word,
    lo = the low 32 bits as a signed int32). Arithmetic is unsigned-carry
    correct and stays in int32 tensors."""
    hi: torch.Tensor
    lo: torch.Tensor

    @staticmethod
    def from_int(x) -> "Addr64":
        """From Python ints or an int64 tensor (built on the host)."""
        x = torch.as_tensor(x, dtype=torch.int64)
        lo = x & 0xFFFFFFFF
        lo = torch.where(lo > INT32_MAX, lo - 2**32, lo)
        return Addr64(hi=(x >> 32).to(torch.int32), lo=lo.to(torch.int32))

    @staticmethod
    def from_parts(hi, lo) -> "Addr64":
        return Addr64(torch.as_tensor(hi, dtype=torch.int32),
                      torch.as_tensor(lo, dtype=torch.int32))

    def add(self, other: "Addr64") -> "Addr64":
        ah, al = _halves(self.lo)
        bh, bl = _halves(other.lo)
        low = al + bl                               # < 2^17
        high = ah + bh + (low >> 16)                # < 2^17
        carry = high >> 16                          # the carry out of lo
        lo = _word(high & _LO16, low & _LO16)
        return Addr64(self.hi + other.hi + carry, lo)

    def add_int32(self, k) -> "Addr64":
        k = torch.as_tensor(k, dtype=torch.int32)
        return self.add(Addr64.from_parts(torch.zeros_like(self.hi),
                                          k.expand_as(self.lo)))


def split64(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy, 64-bit ok) split into (hi, lo) int32 words."""
    x = np.asarray(x, np.int64)
    hi = (x >> 32).astype(np.int32)
    lo = (x & np.int64(0xFFFFFFFF)).astype(np.uint32).astype(np.int64)
    return hi, lo.astype(np.int64)


def combine32(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Inverse of split64 (host-side oracle)."""
    return (np.asarray(hi, np.int64) << 32) | (np.asarray(lo, np.int64)
                                               & 0xFFFFFFFF)


# --------------------------------------------------------------------------
# legalized gathers — the host-pointer-legalizer pass
# --------------------------------------------------------------------------
def legalized_take(table: torch.Tensor, row_ids: torch.Tensor,
                   axis: int = 0) -> torch.Tensor:
    """Embedding-style gather with the promotion analysis applied: the row
    index lives in the row space (provably < vocab < 2^31: NATIVE), never
    in the flat space, so the ids go to the gather as int32 for every
    table of fewer than 2^31 rows."""
    assert axis == 0
    return torch.nn.functional.embedding(
        row_ids.to(index_dtype(table.shape[:1])), table)


def legalized_flat_gather(table: torch.Tensor, flat_idx_hi: torch.Tensor,
                          flat_idx_lo: torch.Tensor) -> torch.Tensor:
    """General 64-bit flat gather in native-width arithmetic: flat element
    offsets given as (hi, lo) int32 words over a 2-D table [R, C] become
    (row, col) by long division by C in four 16-bit limbs, every partial
    value below 2^31 (C < 2^15: :func:`legal_flat_gather_possible`)."""
    assert table.dim() == 2
    C = table.shape[1]
    if not legal_flat_gather_possible(table.shape):
        raise ValueError(f"legalized_flat_gather: C = {C} needs C < 2^15")
    hi = flat_idx_hi.to(torch.int32)
    lo = flat_idx_lo.to(torch.int32)
    q = torch.zeros_like(lo)
    r = torch.zeros_like(lo)
    for p in (*_halves(hi), *_halves(lo)):
        acc = (r << 16) | p           # r < C < 2^15: acc < 2^31
        q = (q << 16) | torch.div(acc, C, rounding_mode="floor")
        r = acc % C
    return table[q, r]


def legal_flat_gather_possible(table_shape: Sequence[int]) -> bool:
    """The signed 16-bit-limb long division above requires C < 2^15."""
    return len(table_shape) == 2 and table_shape[1] < 2**15
