"""granite-moe-3b-a800m [moe] — GQA + 40-expert top-8 MoE.

32L d_model=1536 24H (kv=8) d_ff=512(expert) vocab=49155
[hf:ibm-granite; hf]. 40 experts, each token routed to 8 with
capacity-based dispatch (models/moe.py); the reference keeps the experts
replicated over its model axis (``ep=False``), and so does the port
under a mesh (models/moe.py's slot-parallel path).
"""
from repro_torch.models import moe, transformer


def _base(d_model, n_heads, n_kv, n_layers, vocab, moe_kw, q_chunk=1024):
    return transformer.ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        d_model=d_model, n_heads=n_heads, n_kv=n_kv, d_ff=moe_kw["d_ff"],
        vocab=vocab, groups=((("gqa:moe",), n_layers),),
        moe=moe.MoeConfig(d_model=d_model, router="softmax", ep=False,
                          **moe_kw),
        tie_embeddings=True, remat="full", rope_theta=10000.0,
        q_chunk=q_chunk, kv_chunk=q_chunk,
    )


def config():
    return _base(d_model=1536, n_heads=24, n_kv=8, n_layers=32, vocab=49155,
                 moe_kw=dict(n_experts=40, top_k=8, d_ff=512))


def smoke_config():
    return _base(d_model=64, n_heads=4, n_kv=2, n_layers=2, vocab=512,
                 moe_kw=dict(n_experts=8, top_k=2, d_ff=32), q_chunk=64)
