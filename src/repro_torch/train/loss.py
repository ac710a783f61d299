"""Losses: cross-entropy over the vocabulary, the MoE aux and MTP terms.

Counterpart of ``repro/train/loss.py``. The gold logit is gathered per row
on the vocabulary axis (``take_along_dim``): the index stays within one
row of V logits, never a flat B·L·V offset, which passes int32 at
gemma3 / minitron scale (2·4096·262144 ≈ 2.1e9 > 2³¹).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import addrspace


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits [B, L, V], labels [B, L] int → (mean CE over every token,
    metrics ``nll``, ``ppl_log`` and, with ``z_loss``, ``z_loss``)."""
    V = logits.shape[-1]
    # the per-row gather below indexes one row of V logits at a time
    assert addrspace.index_dtype((V,)) == torch.int32
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)                           # [B, L]
    gold = torch.take_along_dim(lg, labels[..., None].long(),
                                dim=-1)[..., 0]                 # [B, L]
    loss = (lse - gold).mean()
    metrics = {"nll": loss, "ppl_log": loss}
    if z_loss:
        zl = z_loss * torch.square(lse).mean()
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, aux: Dict,
            mtp_weight: float = 0.3, moe_aux_weight: float = 1.0,
            z_loss: float = 0.0):
    """The main CE, plus the MoE load-balance aux (``aux["moe_aux"]``) and
    deepseek's MTP CE on the t+2 targets (``aux["mtp_logits"]`` against
    ``aux["mtp_labels"]``) where the forward gives them."""
    loss, metrics = cross_entropy(logits, labels, z_loss)
    if aux.get("moe_aux") is not None:
        loss = loss + moe_aux_weight * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
    if aux.get("mtp_logits") is not None and \
            aux.get("mtp_labels") is not None:
        mtp_l, _ = cross_entropy(aux["mtp_logits"], aux["mtp_labels"])
        loss = loss + mtp_weight * mtp_l
        metrics["mtp_loss"] = mtp_l
    metrics["loss"] = loss
    return loss, metrics
