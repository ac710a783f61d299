"""hero memory API — the software-managed scratch-pad budget, for the H100.

Counterpart of ``repro/core/heromem.py`` (HEROv2 §2.4): ``hero_lN_capacity``
/ ``hero_lN_malloc`` / ``hero_lN_free`` over each memory level, with the
o1heap model (power-of-two segregated free lists, constant-time malloc and
free, an 8 B granule, a canary word per allocation), copied as it is.

The levels on the card:

  * L1 is the shared memory one thread block may use — the scratch pad the
    AutoDMA planner (core/autodma.py) tiles for, as VMEM was on the TPU;
  * L2 is a slice of the card's HBM3;
  * L3 is host DRAM.

The allocator is planning metadata: CUDA has no device-side malloc on this
path, so the planner asks ``hero_l1_capacity()`` "what fits in L1".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

# --- hardware constants (NVIDIA H100 SXM) ------------------------------------
# Shared memory one block can use: 227 KB of the SM's 256 KB, above 48 KB
# only as dynamic shared memory (NVIDIA H100 data sheet / Hopper tuning
# guide; hopper-kernels §1).
SMEM_PER_BLOCK = 232_448
# Kept back from L1 for the builder kernel's own static shared memory and
# the padding it adds to staged rows (csrc/autodma_tiled.cu).
SMEM_RESERVE = 1024
HBM_BYTES = 80 * 1000**3        # 80 GB of HBM3 (data sheet)
DRAM_BYTES = 64 * 1024**3       # host DRAM budgeted for staging
GRANULE = 8  # paper: "alignment and minimum allocation granule is 8 B"
CANARY = 0x48455232  # "HER2"

# Tiling granules: the last dimension of a tile is a whole number of a
# warp's 32 lanes (coalesced rows); the second-to-last a whole number of
# mma.sync's 16 rows (m16n8k8 TF32, m16n8k16 bf16), for every dtype.
SUBLANE = {8: 16, 4: 16, 2: 16, 1: 16}
LANE = 32


class HeapOverflow(Exception):
    """Raised when a canary check fails (paper: canary mechanism)."""


class OutOfMemory(Exception):
    """Allocation cannot be satisfied within the level's arena."""


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _align(n: int, a: int) -> int:
    return (n + a - 1) // a * a


def fragment_size(nbytes: int) -> int:
    """The o1heap fragment a request of ``nbytes`` occupies (canary word
    added, rounded to a power of two)."""
    return _next_pow2(_align(nbytes + GRANULE, GRANULE))


@dataclasses.dataclass
class _Block:
    offset: int
    size: int       # rounded (power-of-two fragment size), o1heap-style
    requested: int  # caller-visible size
    canary: int = CANARY


class SpmLevel:
    """One scratch-pad level with an o1heap-model allocator.

    ``capacity()`` reports what a worst-case-safe caller may allocate,
    which is what a tiling planner must use.
    """

    def __init__(self, name: str, arena_bytes: int):
        self.name = name
        self.arena = int(arena_bytes)
        self._cursor = 0
        self._blocks: Dict[int, _Block] = {}   # handle -> block
        self._free_bins: Dict[int, list] = {}  # size -> [offset]
        self._next_handle = 1
        self.peak = 0
        self.n_alloc = 0
        self.n_free = 0

    def capacity(self) -> int:
        """``hero_lN_capacity``: the largest allocation guaranteed to
        succeed now (HEROv2 §2.4: read "at the beginning of a tiling region
        to calculate tile sizes"), minus the canary word."""
        linear = self.arena - self._cursor
        best_bin = max((s for s, offs in self._free_bins.items() if offs),
                       default=0)
        return max(0, max(linear, best_bin) - GRANULE)

    def can_alloc(self, nbytes: int) -> bool:
        """True iff ``malloc(nbytes)`` is guaranteed to succeed now."""
        if nbytes <= 0:
            return False
        size = fragment_size(nbytes)
        if self._free_bins.get(size):
            return True
        return _align(self._cursor, GRANULE) + size <= self.arena

    def malloc(self, nbytes: int) -> Optional[int]:
        """``hero_lN_malloc``: a handle (int), or None (POSIX NULL)."""
        if nbytes <= 0:
            return None
        self.n_alloc += 1
        size = fragment_size(nbytes)
        bin_ = self._free_bins.get(size)
        if bin_:
            offset = bin_.pop()
        else:
            offset = _align(self._cursor, GRANULE)
            if offset + size > self.arena:
                return None
            self._cursor = offset + size
        h = self._next_handle
        self._next_handle += 1
        self._blocks[h] = _Block(offset, size, nbytes)
        self.peak = max(self.peak, self._cursor)
        return h

    def free(self, handle: int) -> None:
        """``hero_lN_free``; checks the canary word first."""
        b = self._blocks.pop(handle, None)
        if b is None:
            raise HeapOverflow(f"{self.name}: free of invalid handle {handle}")
        if b.canary != CANARY:
            raise HeapOverflow(f"{self.name}: canary smashed on handle {handle}")
        self.n_free += 1
        self._free_bins.setdefault(b.size, []).append(b.offset)

    def smash_canary(self, handle: int) -> None:
        """Simulate a heap overflow (writes past the allocation)."""
        self._blocks[handle].canary ^= 0xFF

    def in_use(self) -> int:
        return sum(b.size for b in self._blocks.values())


class HeroMemory:
    """The memory hierarchy of one card: L1 = shared memory of one block,
    L2 = an HBM3 slice, L3 = host DRAM."""

    def __init__(self, l1_bytes: int = SMEM_PER_BLOCK - SMEM_RESERVE,
                 l2_bytes: int = HBM_BYTES // 8,
                 l3_bytes: int = DRAM_BYTES // 8):
        self.levels = {1: SpmLevel("L1/SMEM", l1_bytes),
                       2: SpmLevel("L2/HBM", l2_bytes),
                       3: SpmLevel("L3/DRAM", l3_bytes)}

    def capacity(self, level: int) -> int:
        return self.levels[level].capacity()

    def can_alloc(self, level: int, nbytes: int) -> bool:
        return self.levels[level].can_alloc(nbytes)

    def malloc(self, level: int, nbytes: int) -> Optional[int]:
        return self.levels[level].malloc(nbytes)

    def free(self, level: int, handle: int) -> None:
        self.levels[level].free(handle)


# module-level default instance (the paper's per-cluster singleton)
_DEFAULT = HeroMemory()


def hero_l1_capacity() -> int:
    return _DEFAULT.capacity(1)


def hero_l1_malloc(nbytes: int) -> Optional[int]:
    return _DEFAULT.malloc(1, nbytes)


def hero_l1_free(handle: int) -> None:
    _DEFAULT.free(1, handle)


def hero_l2_capacity() -> int:
    return _DEFAULT.capacity(2)


def hero_l2_malloc(nbytes: int) -> Optional[int]:
    return _DEFAULT.malloc(2, nbytes)


def hero_l2_free(handle: int) -> None:
    _DEFAULT.free(2, handle)


def hero_l3_capacity() -> int:
    return _DEFAULT.capacity(3)


def hero_l3_malloc(nbytes: int) -> Optional[int]:
    return _DEFAULT.malloc(3, nbytes)


def hero_l3_free(handle: int) -> None:
    _DEFAULT.free(3, handle)


def paper_tile_side(n_arrays: int, dims: int,
                    capacity_words: Optional[int] = None,
                    word_bytes: int = 4) -> int:
    """The paper's §3.1 tile rule: ``S = floor((L/N)^(1/D))``, with L the
    L1 capacity in words, N the number of arrays, D their dimensionality."""
    if capacity_words is None:
        capacity_words = hero_l1_capacity() // word_bytes
    return int(math.floor((capacity_words / n_arrays) ** (1.0 / dims)))


def aligned_tile(side: int, dtype_bytes: int, dim_is_last: bool) -> int:
    """Round a tile side down to the tiling granule (``LANE`` on the last
    dim, ``SUBLANE`` on the second-to-last); never below the granule."""
    g = LANE if dim_is_last else SUBLANE.get(dtype_bytes, 16)
    return max(g, side // g * g)
