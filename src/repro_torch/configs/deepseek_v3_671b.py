"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H d_ff=2048(expert) vocab=129280 [arXiv:2412.19437; hf].
First 3 layers dense (d_ff 18432, per the HF config), remaining 58 MoE.
MLA latent cache: (512+64)/token a layer (models/attention.py
``mla_forward``). The reference shards the 256 experts over its model axis
(``ep=True``), and so does the port under a mesh (models/moe.py's EP and
a2a paths, ``chip_smoke.py`` phase 10b); serving sets no mesh. Served
by the dense engine only, as in the reference (MLA is not pageable). The
whole model (1.37 TB at bf16) fits no single card: ``chip_smoke.py`` serves
it at full width, cut in depth to 3 dense + 2 MoE layers with the MTP
leaves undrawn (``groups=((("mla:mlp",), 3), (("mla:moe",), 2)),
mtp=False``).
"""
from repro_torch.models import attention, moe, transformer


def _base(d_model, n_heads, n_layers_dense, n_layers_moe, d_ff_dense, vocab,
          mla_kw, moe_kw, q_chunk=1024, kv_chunk=1024):
    return transformer.ModelConfig(
        name="deepseek-v3-671b", family="moe",
        d_model=d_model, n_heads=n_heads, n_kv=n_heads, d_ff=d_ff_dense,
        vocab=vocab,
        groups=((("mla:mlp",), n_layers_dense), (("mla:moe",), n_layers_moe)),
        mla=attention.MlaConfig(d_model=d_model, n_heads=n_heads,
                                q_chunk=q_chunk, kv_chunk=kv_chunk, **mla_kw),
        moe=moe.MoeConfig(d_model=d_model, router="sigmoid", ep=True, **moe_kw),
        mtp=True, remat="full", rope_theta=10000.0,
        q_chunk=q_chunk, kv_chunk=kv_chunk,
    )


def config():
    return _base(
        d_model=7168, n_heads=128, n_layers_dense=3, n_layers_moe=58,
        d_ff_dense=18432, vocab=129280,
        mla_kw=dict(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
        moe_kw=dict(n_experts=256, top_k=8, d_ff=2048, n_shared=1),
    )


def smoke_config():
    return _base(
        d_model=64, n_heads=4, n_layers_dense=1, n_layers_moe=2,
        d_ff_dense=128, vocab=512,
        mla_kw=dict(q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_dim=16),
        moe_kw=dict(n_experts=8, top_k=2, d_ff=32, n_shared=1),
        q_chunk=64, kv_chunk=64,
    )
