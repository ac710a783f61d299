"""Public wrappers for the kernel suite — the hero API surface.

Counterpart of ``repro/kernels/ops.py``: the paper's Table 2 suite and
flash attention. Every suite op takes ``mode`` ∈ {"unmodified", "paper",
"autodma"} mirroring HEROv2 Fig. 7's bars (gemm, 2mm and 3mm also take
``handwritten_tiles``, the fourth bar) and returns only the result; the
plans are returned by the functions of kernels/gemm.py and polybench.py.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gemm_mod
from repro_torch.kernels import polybench as pb
from repro_torch.kernels import ref


def gemm(A, B, alpha=1.0, mode="autodma", body="mxu", handwritten_tiles=None):
    out, _ = gemm_mod.gemm(A, B, alpha=alpha, mode=mode, body=body,
                           handwritten_tiles=handwritten_tiles)
    return out


def mm2(A, B, C, mode="autodma", handwritten_tiles=None):
    out, _ = pb.mm2(A, B, C, mode=mode, handwritten_tiles=handwritten_tiles)
    return out


def mm3(A, B, C, D, mode="autodma", handwritten_tiles=None):
    out, _ = pb.mm3(A, B, C, D, mode=mode,
                    handwritten_tiles=handwritten_tiles)
    return out


def atax(A, x, mode="autodma"):
    out, _ = pb.atax(A, x, mode=mode)
    return out


def bicg(A, p, r, mode="autodma"):
    out, _ = pb.bicg(A, p, r, mode=mode)
    return out


def conv2d(A, c, mode="autodma"):
    out, _ = pb.conv2d(A, c, mode=mode)
    return out


def covar(D, mode="autodma"):
    out, _ = pb.covar(D, mode=mode)
    return out


flash_attention = fa.flash_attention   # returns no plan: nothing to drop


REFS = {
    "gemm": ref.gemm, "mm2": ref.mm2, "mm3": ref.mm3, "atax": ref.atax,
    "bicg": ref.bicg, "conv2d": ref.conv2d, "covar": ref.covar,
    "flash_attention": ref.attention,
}
