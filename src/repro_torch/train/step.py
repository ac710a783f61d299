"""The prefill and decode steps: the path the cross-attention archs run.

Counterpart of the serving half of ``repro/train/step.py``
(``make_prefill_step`` / ``make_decode_step``, ``step.py:93-110``), which
the reference's dry-run lowers for its prefill / decode cells and through
which it runs llama-3.2-vision-11b and whisper-medium: no serving engine
of either package takes their encoder input (``extra``). They run the
recurrent archs (xlstm-1.3b, zamba2-1.2b) as they stand, each layer's
state in the caches, and deepseek-v3's MLA layers over their latent
caches. Both steps are
plain functions over the port's
:class:`~repro_torch.models.transformer.Transformer` and the dense slot
caches of :func:`~repro_torch.models.transformer.init_caches` (written in
place), whose weights must already be at the config's compute dtype::

    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    caches = transformer.init_caches(cfg, B, max_seq, device="cuda")
    logits, caches = prefill(model, prompts, caches, extra=frames)
    tok = logits[:, -1].argmax(-1)[:, None]
    for pos in range(L, L + n):
        logits, caches = decode(model, tok, caches, pos)
        tok = logits[:, -1].argmax(-1)[:, None]

:func:`attention_calls` lists the attention-kernel calls such a run makes,
shape by shape, so that each kernel can be held against its plain version
at exactly those shapes.

The training half of that module (``make_loss_fn`` with deepseek's MTP
term, ``make_train_step``) waits for the training slice, ROADMAP queue 1,
item 16.8.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Tuple

import torch

from repro_torch.models import ssm, transformer


def _check_dtype(cfg: transformer.ModelConfig, model) -> None:
    if model.embed.dtype != cfg.compute_dtype:
        raise ValueError(f"{cfg.name}: the model's weights are "
                         f"{model.embed.dtype}, the compute dtype "
                         f"{cfg.compute_dtype}: cast them first "
                         "(model.to(dtype=cfg.compute_dtype))")


def make_prefill_step(cfg: transformer.ModelConfig):
    """``prefill_step(model, tokens, caches, extra=None)``: tokens [B, L]
    of one length, every slot from position 0, and a cross-attention
    model's encoder input ``extra`` → (the last position's logits [B, 1,
    vocab], caches)."""
    def prefill_step(model, tokens, caches, extra=None):
        _check_dtype(cfg, model)
        h = transformer.hidden(model, tokens, caches, 0, "prefill", extra)
        return transformer.logits(model, h[:, -1:]), caches
    return prefill_step


def make_decode_step(cfg: transformer.ModelConfig):
    """``decode_step(model, tokens, caches, cache_pos)``: tokens [B, 1] at
    ``cache_pos``, the reference's scalar current length (an int or a 0-d
    tensor, every slot there) or a [B] tensor (slot b at its own) →
    (logits [B, 1, vocab], caches)."""
    def decode_step(model, tokens, caches, cache_pos):
        _check_dtype(cfg, model)
        B = tokens.shape[0]
        if isinstance(cache_pos, torch.Tensor):
            pos = cache_pos.to(tokens.device)
            pos = pos.expand(B) if pos.dim() == 0 else pos
        else:   # a fill on the device: no copy from the host, no sync
            pos = torch.full((B,), int(cache_pos), dtype=torch.long,
                             device=tokens.device)
        return transformer.forward(model, tokens, caches, pos, "decode")
    return decode_step


@dataclasses.dataclass(frozen=True)
class AttentionCalls:
    """The calls of one attention kernel from one mixer kind's ``layers``
    in a prefill step and its decode steps. ``kernel`` is
    ``"flash_attention"``, one call a layer (q [B, H, L, hd] over k, v
    [B, H, Lk, hd]: the kv heads repeated ``group`` times, the repeats
    equal), or ``"flash_decode"``, one call a layer a decode step (q [B, H,
    hd] over caches [B, K, S, hd], every slot at that step's entry of
    ``lengths``)."""
    mixer: str
    kernel: str
    q: Tuple[int, ...]
    kv: Tuple[int, ...]
    group: int
    causal: bool
    window: Optional[int]
    lengths: Tuple[int, ...]
    layers: int

    @property
    def launches(self) -> int:
        return self.layers * (len(self.lengths)
                              if self.kernel == "flash_decode" else 1)


def attention_calls(cfg: transformer.ModelConfig, batch: int, prompt: int,
                    max_seq: int, n_new: int) -> List[AttentionCalls]:
    """The attention-kernel calls of ``make_prefill_step`` on ``batch``
    prompts of ``prompt`` tokens (a cross-attention model with its
    ``encoder_seq`` rows of encoder input) and ``n_new - 1``
    ``make_decode_step`` calls at the scalar positions ``prompt, prompt +
    1, ...``, over caches of ``max_seq`` rows: by mixer kind (the encoder's
    first), the prefill's kernel before the decode's. A ``shared`` site
    attends as a ``gqa`` layer does; a recurrent layer (models/ssm.py) or
    an MLA layer (plain PyTorch, as the reference's is plain ``jnp``) calls
    no attention kernel and is not listed."""
    B, H, K, hd = batch, cfg.n_heads, cfg.n_kv, cfg.hd
    G, S_enc = H // K, cfg.encoder_seq
    layers = Counter(transformer.parse_kind(kind)[0]
                     for groups in (cfg.encoder_groups, cfg.groups)
                     for pattern, count in groups
                     for kind in pattern for _ in range(count))
    steps = range(prompt, prompt + n_new - 1)
    out = []
    for mixer, n in layers.items():
        if mixer in ssm.RECURRENT or mixer == "mla":
            continue
        if mixer == "enc":
            out.append(AttentionCalls(mixer, "flash_attention",
                                      (B, H, S_enc, hd), (B, H, S_enc, hd),
                                      G, False, None, (), n))
            continue
        window = cfg.window_of(mixer)
        if mixer == "cross":
            Lk, S, lengths = S_enc, S_enc, (S_enc,) * len(steps)
        else:
            Lk = prompt
            S = min(max_seq, window) if window else max_seq
            lengths = tuple(min(p + 1, S) for p in steps)
        out.append(AttentionCalls(mixer, "flash_attention",
                                  (B, H, prompt, hd), (B, H, Lk, hd), G,
                                  mixer != "cross", window, (), n))
        out.append(AttentionCalls(mixer, "flash_decode", (B, H, hd),
                                  (B, K, S, hd), G, False, window, lengths,
                                  n))
    return out
