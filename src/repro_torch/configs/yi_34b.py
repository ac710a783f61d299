"""yi-34b [dense] — llama-arch GQA, untied, no QKV bias.

60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000 [arXiv:2403.04652; hf].
"""
from repro_torch.models import transformer


def _base(d_model, n_heads, n_kv, d_ff, n_layers, vocab, q_chunk=1024):
    return transformer.ModelConfig(
        name="yi-34b", family="dense",
        d_model=d_model, n_heads=n_heads, n_kv=n_kv, d_ff=d_ff, vocab=vocab,
        groups=((("gqa:mlp",), n_layers),),
        rope_theta=5000000.0, remat="full",
        q_chunk=q_chunk, kv_chunk=q_chunk,
    )


def config():
    return _base(7168, 56, 8, 20480, 60, 64000)


def smoke_config():
    return _base(64, 4, 2, 128, 2, 512, q_chunk=64)
