"""Blockwise flash attention in plain PyTorch with a custom backward.

Counterpart of ``repro/models/flash_xla.py``: the attention of every layer
that runs with no cache (the training forward, ``models/attention.py``).
The reference writes it in plain XLA ops with a ``jax.custom_vjp`` and
reaches no ``pallas_call``; this is the same algorithm as a
``torch.autograd.Function`` of plain PyTorch ops. Differentiating a
blockwise loop with plain autograd would save every block's running
(max, sum, accumulator) for the backward; the forward here saves only
(out, lse), and the backward recomputes the probabilities block by block
from the log-sum-exp (the reference's docstring has the numbers).

Semantics, as the reference's: q [B, H, Lq, hd] over k, v [B, K, Lkv, hd]
(GQA: query head ``h = k·G + g``), math in f32, the query and key axes cut
into the largest chunks ≤ ``q_chunk`` / ``kv_chunk`` that divide them
(:func:`_chunks`), logits ``q·k / sqrt(hd)``, an optional tanh softcap
applied before the mask, masks by absolute position (``causal``: key ≤
query; ``window``: key > query − window; queries at ``q_offset + i``) and
an optional ``kv_len_mask`` [B, Lkv], masked logits ``NEG``, every key
block computed for every query block. A row that sees no key takes the
mean of V, as the reference's does (its running max stays at ``NEG``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG = -1e30


def _chunks(L: int, c: int) -> Tuple[int, int]:
    """(count, size) of the largest chunk ≤ c that divides L exactly."""
    c = max(1, min(c, L))
    while L % c:
        c -= 1
    return L // c, c


def _mask(qs: int, qc: int, ks: int, kc: int, causal: bool,
          window: Optional[int], q_offset: int, kv_len_mask, device):
    """The block's visibility, broadcasting to [B, K, G, qc, kc] (None when
    every pair is visible)."""
    m = None
    if causal or window is not None:
        qpos = q_offset + qs + torch.arange(qc, device=device)[:, None]
        kpos = ks + torch.arange(kc, device=device)[None, :]
        m = torch.ones(qc, kc, dtype=torch.bool, device=device)
        if causal:
            m &= kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
    if kv_len_mask is not None:
        valid = kv_len_mask[:, None, None, None, ks:ks + kc]
        m = valid if m is None else m & valid
    return m


def _qk(qblk: torch.Tensor, kblk: torch.Tensor) -> torch.Tensor:
    """qblk [B, K, G, qc, hd] · kblk [B, K, kc, hd] → [B, K, G, qc, kc]."""
    B, K, G, qc, hd = qblk.shape
    return (qblk.reshape(B, K, G * qc, hd) @ kblk.transpose(-1, -2)
            ).reshape(B, K, G, qc, -1)


def _pv(p: torch.Tensor, vblk: torch.Tensor) -> torch.Tensor:
    """p [B, K, G, qc, kc] · v [B, K, kc, hd] → [B, K, G, qc, hd]."""
    B, K, G, qc, kc = p.shape
    return (p.reshape(B, K, G * qc, kc) @ vblk).reshape(B, K, G, qc, -1)


def _t_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_{g, q} a[..., g, q, s] · b[..., g, q, d]: a [B, K, G, qc, kc], b
    [B, K, G, qc, hd] → [B, K, kc, hd]."""
    B, K, G, qc, kc = a.shape
    return a.reshape(B, K, G * qc, kc).transpose(-1, -2) @ \
        b.reshape(B, K, G * qc, -1)


def _blocks(x: torch.Tensor, qs: int, qc: int) -> torch.Tensor:
    """Query block ``[qs, qs + qc)`` of x [B, K, G, L, d] as a contiguous
    [B, K, G, qc, d]."""
    return x[:, :, :, qs:qs + qc].contiguous()


def _forward(q, k, v, causal, window, softcap, q_chunk, kv_chunk, q_offset,
             kv_len_mask):
    B, H, Lq, hd = q.shape
    K, Lkv = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    _, qc = _chunks(Lq, q_chunk)
    _, kc = _chunks(Lkv, kv_chunk)
    qg = q.reshape(B, K, G, Lq, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.empty(B, K, G, Lq, hd, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, K, G, Lq, dtype=torch.float32, device=q.device)
    for qs in range(0, Lq, qc):
        qblk = _blocks(qg, qs, qc)
        m_run = torch.full((B, K, G, qc), -math.inf, device=q.device)
        l_run = torch.zeros(B, K, G, qc, device=q.device)
        acc = torch.zeros(B, K, G, qc, hd, device=q.device)
        for ks in range(0, Lkv, kc):
            logits = _qk(qblk, kf[:, :, ks:ks + kc]) * scale
            if softcap:
                logits = torch.tanh(logits / softcap) * softcap
            m = _mask(qs, qc, ks, kc, causal, window, q_offset, kv_len_mask,
                      q.device)
            if m is not None:
                logits = logits.masked_fill(~m, NEG)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _pv(p, vf[:, :, ks:ks + kc])
            m_run = m_new
        l_run = l_run.clamp_min(1e-30)
        out[:, :, :, qs:qs + qc] = acc / l_run[..., None]
        lse[:, :, :, qs:qs + qc] = m_run + torch.log(l_run)
    return out.reshape(B, H, Lq, hd).to(q.dtype), lse


def _backward(q, k, v, out, lse, dout, causal, window, softcap, q_chunk,
              kv_chunk, q_offset, kv_len_mask):
    B, H, Lq, hd = q.shape
    K, Lkv = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    _, qc = _chunks(Lq, q_chunk)
    _, kc = _chunks(Lkv, kv_chunk)
    qg = q.reshape(B, K, G, Lq, hd).float()
    dog = dout.reshape(B, K, G, Lq, hd).float()
    D = (out.reshape(B, K, G, Lq, hd).float() * dog).sum(dim=-1)  # [B,K,G,Lq]
    kf, vf = k.float(), v.float()
    dq = torch.empty(B, K, G, Lq, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, K, Lkv, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros(B, K, Lkv, hd, dtype=torch.float32, device=q.device)
    for qs in range(0, Lq, qc):
        qblk, doblk = _blocks(qg, qs, qc), _blocks(dog, qs, qc)
        lseblk = lse[:, :, :, qs:qs + qc, None]
        Dblk = D[:, :, :, qs:qs + qc, None]
        dq_blk = torch.zeros(B, K, G, qc, hd, device=q.device)
        for ks in range(0, Lkv, kc):
            kblk, vblk = kf[:, :, ks:ks + kc], vf[:, :, ks:ks + kc]
            raw = _qk(qblk, kblk) * scale
            logits = raw
            if softcap:
                t = torch.tanh(raw / softcap)
                logits = t * softcap
            m = _mask(qs, qc, ks, kc, causal, window, q_offset, kv_len_mask,
                      q.device)
            if m is not None:
                logits = logits.masked_fill(~m, NEG)
            p = torch.exp(logits - lseblk)                 # [B,K,G,qc,kc]
            dp = _qk(doblk, vblk)
            ds = p * (dp - Dblk)
            if softcap:                     # through the softcap, then scale
                ds = ds * (1.0 - torch.square(t))
            ds = ds * scale
            dq_blk += _pv(ds, kblk)
            dk[:, :, ks:ks + kc] += _t_sum(ds, qblk)
            dv[:, :, ks:ks + kc] += _t_sum(p, doblk)
        dq[:, :, :, qs:qs + qc] = dq_blk
    return (dq.reshape(B, H, Lq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashXla(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_chunk, kv_chunk,
                q_offset, kv_len_mask):
        out, lse = _forward(q, k, v, causal, window, softcap, q_chunk,
                            kv_chunk, q_offset, kv_len_mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, q_chunk, kv_chunk, q_offset,
                    kv_len_mask)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: Optional[int],
                        softcap: Optional[float], q_chunk: int,
                        kv_chunk: int, q_offset: int = 0,
                        kv_len_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q [B, H, Lq, hd], k, v [B, K, Lkv, hd] → [B, H, Lq, hd] at q's
    dtype, differentiable in q, k and v. ``q_offset``: the int added to the
    query positions; ``kv_len_mask``: [B, Lkv] bool validity or None."""
    return _FlashXla.apply(q, k, v, causal, window, softcap, q_chunk,
                           kv_chunk, int(q_offset), kv_len_mask)
