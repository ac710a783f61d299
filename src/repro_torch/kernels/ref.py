"""Plain PyTorch oracles for the kernels.

Counterpart of ``repro/kernels/ref.py``: the paper's Table 2 oracles (gemm,
2mm, 3mm, atax, bicg, conv2d, covar) and the attention oracles. The paged
oracles (gather, dequantise, then these) live beside their kernels, in
paged_decode_attention.py and paged_prefill_attention.py, as in the
reference.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


# --- paper Table 2 ----------------------------------------------------------
def gemm(A, B, alpha=1.0, beta=0.0, C=None):
    """C = beta·C + alpha·A·B (darknet conv-as-gemm is the same kernel)."""
    out = alpha * (A @ B)
    if C is not None and beta != 0.0:
        out = out + beta * C
    return out


def mm2(A, B, C, alpha=1.0):
    """2mm: tmp = alpha·A·B ; out = tmp·C."""
    return (alpha * (A @ B)) @ C


def mm3(A, B, C, D):
    """3mm: E=A·B ; F=C·D ; G=E·F."""
    return (A @ B) @ (C @ D)


def atax(A, x):
    """y = Aᵀ(A x)."""
    return A.T @ (A @ x)


def bicg(A, p, r):
    """q = A p ; s = Aᵀ r."""
    return A @ p, A.T @ r


def conv2d(A, c):
    """3×3 stencil, zero-padded borders. c: [3,3]."""
    Ap = torch.nn.functional.pad(A, (1, 1, 1, 1))
    out = torch.zeros_like(A)
    for di in range(3):
        for dj in range(3):
            out = out + c[di, dj] * Ap[di:di + A.shape[0], dj:dj + A.shape[1]]
    return out


def covar(D):
    """Column-mean-center, then S = Dᵀ D / (M−1)."""
    M = D.shape[0]
    Dc = D - D.mean(dim=0, keepdim=True)
    return (Dc.T @ Dc) / (M - 1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
    """One query token vs a ragged KV cache: masked-softmax oracle.

    q: [B, H, hd]; k/v_cache: [B, K, S, hd]; lengths: [B] valid counts.
    GQA groups G = H/K query heads per kv head (head h = k·G + g).
    """
    B, H, hd = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    logits = logits / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window=None, softcap=None) -> torch.Tensor:
    """q, k, v: [B, H, L, hd] (MHA; GQA broadcast upstream); ``softcap``
    caps the scaled logits as ``tanh(s / softcap) · softcap``."""
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    qi = torch.arange(Lq, device=q.device)[:, None]
    kj = torch.arange(Lk, device=q.device)[None, :]
    m = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kj <= qi
    if window is not None:
        m &= kj > qi - window
    logits = logits.masked_fill(~m, NEG)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def masked_attend(logits: torch.Tensor, visible: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """The kernels' softmax, written out: logits [..., R, S] f32, visible a
    bool mask broadcastable to them, v [..., S, hd]. Masked keys get
    probability exactly 0 and a row that sees no key returns 0 (acc /
    max(l, 1e-30)), as the paged kernels do; elsewhere it equals
    ``softmax(logits) @ v``."""
    logits = logits.masked_fill(~visible, NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~visible, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (p @ v) / denom
