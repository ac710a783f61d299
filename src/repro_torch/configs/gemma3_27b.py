"""gemma3-27b [dense] — 5:1 local(1024-window):global attention, 128k+.

62L d_model=5376 32H (kv=16) d_ff=21504 vocab=262144 head_dim=128
[hf:google/gemma-3-1b-pt; unverified]. 62 = 10×(5 local + 1 global) + 2 local.
Zero-centred RMS norm scales, sandwich (post-attention and post-MLP) norms,
the embedding scaled by √d_model, a tied head. Local layers keep a ring of
``min(max_seq, window)`` cache rows a slot (models/attention.py).
Deviation noted: one rope_theta for local+global (gemma3 uses 10k/1M split).
"""
from repro_torch.models import transformer


def _base(d_model, n_heads, n_kv, d_ff, n_units, n_rem, vocab, window,
          head_dim, q_chunk=1024, shard_kv_seq=False):
    groups = [((("local:mlp",) * 5 + ("global:mlp",)), n_units)]
    if n_rem:
        groups.append((("local:mlp",), n_rem))
    return transformer.ModelConfig(
        name="gemma3-27b", family="dense",
        d_model=d_model, n_heads=n_heads, n_kv=n_kv, d_ff=d_ff, vocab=vocab,
        groups=tuple(groups), head_dim=head_dim, window=window,
        zero_centered_norm=True, sandwich_norm=True, embed_scale=True,
        tie_embeddings=True, rope_theta=10000.0, remat="full",
        q_chunk=q_chunk, kv_chunk=q_chunk, shard_kv_seq=shard_kv_seq,
    )


def config():
    return _base(5376, 32, 16, 21504, 10, 2, 262144, window=1024, head_dim=128)


def smoke_config():
    return _base(64, 4, 2, 128, 1, 1, 512, window=8, head_dim=16, q_chunk=64)
