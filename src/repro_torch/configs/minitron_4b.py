"""minitron-4b [dense] — pruned nemotron: squared-ReLU MLP, untied.

32L d_model=3072 24H (kv=8) d_ff=9216 vocab=256000 [arXiv:2407.14679; hf].
"""
from repro_torch.models import transformer


def _base(d_model, n_heads, n_kv, d_ff, n_layers, vocab, q_chunk=1024):
    return transformer.ModelConfig(
        name="minitron-4b", family="dense",
        d_model=d_model, n_heads=n_heads, n_kv=n_kv, d_ff=d_ff, vocab=vocab,
        groups=((("gqa:mlp",), n_layers),),
        mlp="relu2", rope_theta=10000.0, remat="full",
        q_chunk=q_chunk, kv_chunk=q_chunk,
    )


def config():
    return _base(3072, 24, 8, 9216, 32, 256000)


def smoke_config():
    return _base(64, 4, 2, 128, 2, 512, q_chunk=64)
