"""llama-3.2-vision-11b [vlm] — GQA decoder + cross-attention image layers.

40L d_model=4096 32H (kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. Every 5th layer cross-
attends to STUB patch embeddings (the caller supplies [B, 1600, d_model] —
the modality frontend is a stub per the assignment). No serving engine
takes it: it runs through the prefill / decode steps (train/step.py).
"""
import dataclasses

from repro_torch.models import transformer

N_PATCHES = 1600


def _base(d_model, n_heads, n_kv, d_ff, n_units, vocab, q_chunk=1024):
    return transformer.ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        d_model=d_model, n_heads=n_heads, n_kv=n_kv, d_ff=d_ff, vocab=vocab,
        groups=(((("gqa:mlp",) * 4 + ("cross:mlp",)), n_units),),
        cross_kv_dim=d_model, encoder_seq=N_PATCHES,
        rope_theta=500000.0, remat="full",
        q_chunk=q_chunk, kv_chunk=q_chunk,
    )


def config():
    return _base(d_model=4096, n_heads=32, n_kv=8, d_ff=14336, n_units=8,
                 vocab=128256)  # 40 layers


def smoke_config():
    cfg = _base(d_model=64, n_heads=4, n_kv=2, d_ff=128, n_units=1,
                vocab=512, q_chunk=64)
    return dataclasses.replace(cfg, encoder_seq=16)
