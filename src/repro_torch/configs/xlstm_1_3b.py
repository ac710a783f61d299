"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]).

48L d_model=2048 4H vocab=50304 d_ff=0 (blocks carry their own projections)
[arXiv:2405.04517; unverified]. Constant-state recurrence: the dense slot
caches hold each layer's state, whatever ``max_seq`` is. Served by the
dense engine only, as in the reference (its layers are not pageable).
"""
from repro_torch.models import ssm, transformer


def _base(d_model, n_units, vocab, n_heads=4, chunk=128):
    return transformer.ModelConfig(
        name="xlstm-1.3b", family="ssm",
        d_model=d_model, n_heads=n_heads, n_kv=n_heads, d_ff=0, vocab=vocab,
        groups=(((("mlstm:none",) * 7 + ("slstm:none",)), n_units),),
        mlstm=ssm.MlstmConfig(d_model=d_model, n_heads=n_heads, chunk=chunk),
        slstm=ssm.SlstmConfig(d_model=d_model, n_heads=n_heads),
        rope_theta=None, tie_embeddings=True, remat="full",
    )


def config():
    return _base(d_model=2048, n_units=6, vocab=50304)  # 48 layers


def smoke_config():
    return _base(d_model=64, n_units=1, vocab=512, chunk=32)
