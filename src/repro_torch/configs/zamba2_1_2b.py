"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-SHARED attention block.

38L d_model=2048 32H (kv=32, MHA) d_ff=8192 ssm_state=64
[arXiv:2411.15242; hf]. 38 = 6×(5 mamba + 1 shared-attn) + 2 mamba; the
'shared' kind reuses ONE attention+MLP weight copy at every invocation
(zamba's parameter-sharing trick) with per-site KV caches. Served by the
dense engine only, as in the reference (Mamba2 layers are not pageable).
"""
from repro_torch.models import ssm, transformer


def _base(d_model, n_heads, d_ff, n_units, n_rem, vocab, d_state, head_dim,
          chunk=128, q_chunk=1024, shard_kv_seq=False):
    groups = [((("mamba:none",) * 5 + ("shared:mlp",)), n_units)]
    if n_rem:
        groups.append((("mamba:none",), n_rem))
    return transformer.ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        d_model=d_model, n_heads=n_heads, n_kv=n_heads, d_ff=d_ff, vocab=vocab,
        groups=tuple(groups),
        mamba=ssm.Mamba2Config(d_model=d_model, d_state=d_state,
                               head_dim=head_dim, chunk=chunk),
        tie_embeddings=True, rope_theta=10000.0, remat="full",
        q_chunk=q_chunk, kv_chunk=q_chunk, shard_kv_seq=shard_kv_seq,
    )


def config():
    return _base(2048, 32, 8192, 6, 2, 32000, d_state=64, head_dim=64)


def smoke_config():
    return _base(64, 4, 128, 1, 1, 512, d_state=8, head_dim=16, chunk=32,
                 q_chunk=64)
