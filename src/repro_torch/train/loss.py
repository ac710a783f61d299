"""Losses: cross-entropy over the vocabulary, the MoE aux and MTP terms.

Counterpart of ``repro/train/loss.py``. The gold logit is gathered per row
on the vocabulary axis (``take_along_dim``): the index stays within one
row of V logits, never a flat B·L·V offset, which passes int32 at
gemma3 / minitron scale (2·4096·262144 ≈ 2.1e9 > 2³¹).

**Over a vocabulary line** (the training forward on a rank whose head is
cut over ``vocab_tp``: models/transformer.py ``train_forward``'s
``aux["vocab"]``) each rank holds the logits of its columns ``[lo, hi)``
and no rank gathers them whole (for qwen2-0.5b's ``train_4k`` on 16x16
that is 2.49 GB of f32 logits a rank instead of 39.8 GB). The log-sum-exp
is taken about the line's max (``sharding.max_over``, no gradient), its
Σ exp summed over the line (``reduce_from``); the gold logit comes from
the rank whose columns hold the label (zero on the others), summed over
the line too. Every rank then holds the same loss, and its backward
reaches each rank's logits alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import addrspace
from repro_torch.parallel import sharding


def _lse_gold(lg: torch.Tensor, labels: torch.Tensor,
              vocab: Optional[sharding.Held]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp, gold logit) of f32 logits ``lg`` [B, L, V or its
    part] at ``labels``, over ``vocab``'s line when it has one."""
    if vocab is None or vocab.line is None:
        lse = torch.logsumexp(lg, dim=-1)                           # [B, L]
        gold = torch.take_along_dim(lg, labels[..., None].long(),
                                    dim=-1)[..., 0]                 # [B, L]
        return lse, gold
    m = sharding.max_over(lg.amax(dim=-1), vocab.line)
    total = sharding.reduce_from(torch.exp(lg - m[..., None]).sum(-1),
                                 vocab.line)
    local = labels.long() - vocab.lo
    inside = (local >= 0) & (local < lg.shape[-1])
    gold = torch.take_along_dim(lg, local.clamp(0, lg.shape[-1] - 1)[
        ..., None], dim=-1)[..., 0]
    gold = sharding.reduce_from(torch.where(inside, gold,
                                            torch.zeros_like(gold)),
                                vocab.line)
    return m + torch.log(total), gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0,
                  vocab: Optional[sharding.Held] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits [B, L, V], labels [B, L] int → (mean CE over every token,
    metrics ``nll``, ``ppl_log`` and, with ``z_loss``, ``z_loss``).
    ``vocab``: the part ``[lo, hi)`` of the vocabulary ``logits`` hold and
    its line (the module docstring); None, or no line: the whole."""
    V = logits.shape[-1]
    # the per-row gather below indexes one row of V logits at a time
    assert addrspace.index_dtype((V,)) == torch.int32
    lse, gold = _lse_gold(logits.float(), labels, vocab)
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
    """The main CE (over ``aux["vocab"]``'s line where the head is cut
    over the vocabulary), plus the MoE load-balance aux
    (``aux["moe_aux"]``) and deepseek's MTP CE on the t+2 targets
    (``aux["mtp_logits"]``, from the same head and so over the same
    line, against ``aux["mtp_labels"]``) where the forward gives them."""
    loss, metrics = cross_entropy(logits, labels, z_loss, aux.get("vocab"))
    if aux.get("moe_aux") is not None:
        loss = loss + moe_aux_weight * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
    if aux.get("mtp_logits") is not None and \
            aux.get("mtp_labels") is not None:
        mtp_l, _ = cross_entropy(aux["mtp_logits"], aux["mtp_labels"],
                                 vocab=aux.get("vocab"))
        loss = loss + mtp_weight * mtp_l
        metrics["mtp_loss"] = mtp_l
    metrics["loss"] = loss
    return loss, metrics
