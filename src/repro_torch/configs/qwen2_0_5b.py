"""qwen2-0.5b [dense] — GQA with QKV bias, tied embeddings.

24L d_model=896 14H (kv=2) d_ff=4864 vocab=151936 [arXiv:2407.10671; hf].
"""
from repro_torch.models import transformer


def _base(d_model, n_heads, n_kv, d_ff, n_layers, vocab, q_chunk=1024,
          shard_kv_seq=True):
    return transformer.ModelConfig(
        name="qwen2-0.5b", family="dense",
        d_model=d_model, n_heads=n_heads, n_kv=n_kv, d_ff=d_ff, vocab=vocab,
        groups=((("gqa:mlp",), n_layers),),
        qkv_bias=True, tie_embeddings=True, rope_theta=1000000.0,
        remat="full", q_chunk=q_chunk, kv_chunk=q_chunk,
        shard_kv_seq=shard_kv_seq,
    )


def config():
    return _base(896, 14, 2, 4864, 24, 151936)


def smoke_config():
    return _base(64, 4, 2, 128, 2, 512, q_chunk=64, shard_kv_seq=False)
