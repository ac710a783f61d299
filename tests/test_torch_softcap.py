"""Softcap attention on the dense serving path.

A config's ``logit_softcap`` c caps each scaled attention logit s as
tanh(s / c)·c before the mask (the reference's ``_decode_attend``,
``repro/models/attention.py:195-210``, and its ``_attend_streaming`` at a
prefill). The port's ``flash_decode`` takes the cap (its plain version on
the CPU, ``csrc/decode_attention.cu`` on the card) and so does
``flash_attention``; ``gqa_forward`` / ``cross_forward`` pass the config's.

  * ``flash_decode_plain`` with a cap against the reference's
    ``_decode_attend`` on ragged lengths (a slot of length 0 included), at
    bf16 and f32, and its lse against the log-sum-exp of the capped logits;
  * the dense engine's greedy streams on qwen2-0.5b's f32 smoke config
    with a cap, equal to the reference's dense engine (equal prompt
    lengths: its engine runs every slot at one shared position), with a
    cap small enough that the streams differ from the uncapped ones;
  * the paged pool still refuses a capped config, as the reference's does;
  * on the card (``cuda``): the kernel against its plain version.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models.attention import AttnConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro_torch.kernels import decode_attention as tda
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.kvcache import PagedCachePool

from test_torch_model import _weights

CAP = 0.5            # small enough that the smoke model's streams change
PROMPTS = ((6, 6, 6, 6), 1, 5, 2)   # lengths, seed, max_new, slots


def _decode_case(rng, B, H, K, S, hd, dtype):
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    lengths = np.array([S, 1, 0, S // 2 + 3][:B], np.int32)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return (q, k, v, lengths), t + [torch.from_numpy(lengths)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("cap", (1.0, 30.0))
def test_flash_decode_plain_softcap_matches_decode_attend(cap, dtype):
    """Output against ``_decode_attend`` with ``logit_softcap`` (the same
    bf16-rounded inputs on both sides); lse against the log-sum-exp of the
    capped, scaled logits of each row's visible keys (NEG + log S for the
    empty slot, which is NEG in f32)."""
    B, H, K, S, hd = 4, 8, 2, 96, 32
    rng = np.random.default_rng(3)
    (*_, lens), (q, k, v, lengths) = _decode_case(rng, B, H, K, S, hd, dtype)
    out, lse = tda.flash_decode_plain(q, k, v, lengths, block_k=32,
                                      return_lse=True, softcap=cap)
    assert torch.equal(out, tda.flash_decode_plain(
        q, k, v, lengths, block_k=32, softcap=cap))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    valid = np.arange(S)[None, :] < lens[:, None]
    cfg = AttnConfig(d_model=H * hd, n_heads=H, n_kv=K, head_dim=hd,
                     logit_softcap=cap)
    want = jattention._decode_attend(
        jnp.asarray(q.float().numpy(), jdt)[:, :, None],
        jnp.asarray(k.float().numpy(), jdt), jnp.asarray(v.float().numpy(),
                                                         jdt),
        jnp.asarray(valid), cfg)[:, :, 0]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    s = np.einsum("bkgd,bksd->bkgs",
                  q.float().numpy().reshape(B, K, H // K, hd),
                  k.float().numpy()) / np.sqrt(hd)
    s = np.tanh(s / cap) * cap
    s = np.where(valid[:, None, None], s, tda.NEG)
    m = s.max(-1, keepdims=True)
    ref_lse = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(B, H)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)
    uncapped = tda.flash_decode_plain(q, k, v, lengths, block_k=32)
    assert not torch.equal(out, uncapped)


def test_flash_decode_softcap_reports_the_tanh_flops():
    """The meta launch (a dry run's traced pass) reports the plain
    version's products and three more FLOPs a logit for the cap."""
    from repro_torch.core import perf
    B, H, K, S, hd = 2, 4, 2, 64, 16
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(B, H, hd, **meta)
    kc, vc = (torch.empty(B, K, S, hd, **meta) for _ in range(2))
    lens = torch.empty(B, dtype=torch.int32, device="meta")
    for cap, extra in ((None, 0), (30.0, 3 * B * H * S)):
        with perf.TraceCount() as count:
            tda.flash_decode(q, kc, vc, lens, softcap=cap)
        assert count.kernel_flops == {
            "flash_decode": 4 * B * H * hd * S + extra}


def _serve(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        assert eng.submit(request_cls(seq_id=i, prompt=p.copy(),
                                      max_new=max_new))
    done = eng.run(max_steps=1000)
    assert eng.idle and len(done) == len(prompts)
    return {int(r.seq_id): list(r.tokens_out) for r in done}


def test_dense_engine_softcap_streams_equal_the_reference():
    """qwen2-0.5b's f32 smoke config (QKV biases perturbed) with
    ``logit_softcap`` CAP: the port's dense engine gives the reference
    dense engine's greedy streams, and they differ from the uncapped
    streams, so the cap shows."""
    cfg, params, tree, tcfg = _weights()
    lens, seed, max_new, slots = PROMPTS
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    got = {}
    for cap in (None, CAP):
        jcfg = dataclasses.replace(cfg, logit_softcap=cap)
        ref = _serve(JEngine(jcfg, params, config=JEngineConfig(
            n_slots=slots, max_seq=64)), JRequest, prompts, max_new)
        tc = dataclasses.replace(tcfg, logit_softcap=cap)
        got[cap] = _serve(TEngine(
            tc, params_from_numpy(tree, tc), device="cpu",
            config=TEngineConfig(n_slots=slots, max_seq=64)),
            TRequest, prompts, max_new)
        assert got[cap] == ref, cap
    assert got[CAP] != got[None]


def test_paged_pool_still_refuses_a_softcap():
    tcfg = dataclasses.replace(_weights()[3], logit_softcap=CAP)
    with pytest.raises(ValueError, match="softcap"):
        PagedCachePool(tcfg, max_batch=2, max_seq=32, n_pages=8,
                       page_tokens=8)
    with pytest.raises(ValueError, match="softcap"):
        TEngine(tcfg, params_from_numpy(_weights()[2], tcfg), device="cpu",
                config=TEngineConfig(cache=TCacheConfig(paged=True,
                                                        page_tokens=8),
                                     n_slots=2, max_seq=32))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("hd", (64, 128))
def test_flash_decode_softcap_kernel_matches_plain(hd, dtype):
    """The CUDA kernel with a cap against its plain version on the same
    card inputs (output and lse), ragged lengths and an empty slot."""
    B, H, K, S = 4, 14, 2, 1000
    rng = np.random.default_rng(4)
    _, t = _decode_case(rng, B, H, K, S, hd, dtype)
    q, k, v, lengths = (a.cuda() for a in t)
    out, lse = tda.flash_decode(q, k, v, lengths, return_lse=True,
                                softcap=CAP * 60)
    ref, ref_lse = tda.flash_decode_plain(q, k, v, lengths, return_lse=True,
                                          softcap=CAP * 60)
    step = 2e-3 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(out.float(), ref.float(), atol=step,
                               rtol=step)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
