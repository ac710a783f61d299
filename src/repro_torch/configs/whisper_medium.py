"""whisper-medium [audio] — enc-dec with stub conv frontend.

24L(enc)+24L(dec) d_model=1024 16H d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]. The conv frontend is a STUB per assignment:
the caller provides precomputed frame embeddings [B, 1500, d_model].
Decoder layer = self-attn (no FFN) → cross-attn + FFN (equivalent factoring
of whisper's self→cross→mlp block). LayerNorm + GELU + learned positions.
Decoding past whisper's trained maximum of 448 positions reuses the last
learned row, as the reference clips. No serving engine takes it: it runs
through the prefill / decode steps (train/step.py).
"""
from repro_torch.models import transformer

N_FRAMES = 1500


def _base(d_model, n_heads, d_ff, n_layers, vocab, enc_seq, learned_pos,
          q_chunk=1024):
    return transformer.ModelConfig(
        name="whisper-medium", family="audio",
        d_model=d_model, n_heads=n_heads, n_kv=n_heads, d_ff=d_ff, vocab=vocab,
        groups=((("gqa:none", "cross:mlp"), n_layers),),
        encoder_groups=((("enc:mlp",), n_layers),),
        encoder_seq=enc_seq, cross_kv_dim=d_model,
        norm="layer", mlp="gelu", qkv_bias=True,
        rope_theta=None, learned_pos=learned_pos, remat="full",
        q_chunk=q_chunk, kv_chunk=q_chunk,
    )


def config():
    return _base(1024, 16, 4096, 24, 51865, N_FRAMES, learned_pos=448)


def smoke_config():
    return _base(64, 4, 128, 2, 512, enc_seq=16, learned_pos=64, q_chunk=64)
