"""The train-mode forward and its loss gradient against the JAX package,
for the archs with other mixers: llama-3.2-vision-11b (cross-attention
over stub patches), whisper-medium (the ``enc`` encoder, cross layers,
learned positions, layer norms, the GELU MLP), xlstm-1.3b (mLSTM /
sLSTM with no state), zamba2-1.2b (Mamba2 and the weight-shared
attention block) and deepseek-v3-671b (the no-cache MLA forward, the
sigmoid-routed MoE's aux, the MTP head: ``mtp_logits`` and the MTP loss
term). The checks are tests/test_torch_train_dense.py's (within 1e-5;
xlstm-1.3b within 1e-4, as its serving tests: its exponential gates
amplify f32 rounding). Also the no-cache MLA layer alone against the
reference's ``mla_forward`` with no cache, output and gradients, and the
train forward refusing a cross-attention model without ``extra``.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.models import attention as tattention
from repro_torch.models import transformer as ttransformer
from test_torch_train_common import (batch, close_scaled, jax_batch,
                                     jax_params, model, torch_batch,
                                     weights)
from test_torch_train_dense import check_forward, check_grads

ARCHS = ("llama-3.2-vision-11b", "whisper-medium", "xlstm-1.3b",
         "zamba2-1.2b", "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_equals_jax(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_equals_jax(arch):
    check_grads(arch)


def test_no_cache_mla_layer_equals_jax():
    """One MLA layer with no cache (K/V expanded, V padded from v_dim to
    qk_nope + qk_rope): output and the gradients of its input and every
    weight against the reference's ``mla_forward`` with no cache."""
    from repro.models import attention as jattention
    cfg, tree, tcfg = weights("deepseek-v3-671b")
    mla = tcfg.mla
    jp = {k: jax.numpy.asarray(v[0]) for k, v in
          tree["groups"][0][0]["mixer"].items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, mla.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    dy = rng.standard_normal((2, 12, mla.d_model)).astype(np.float32)

    def f(p, xx):
        y, c = jattention.mla_forward(p, xx, pos, cfg.mla)
        assert c is None
        return jax.numpy.sum(y * dy), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(jp, x)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = tattention.mla_forward(tp, tx, torch.from_numpy(pos), mla)
    (ty * torch.from_numpy(dy)).sum().backward()
    close_scaled(ty, jy, 1e-5)
    close_scaled(tx.grad, jgx, 1e-5)
    for k in jp:
        close_scaled(tp[k].grad, jgp[k], 1e-5)


def test_cross_archs_need_extra_in_training():
    for arch in ("llama-3.2-vision-11b", "whisper-medium"):
        b = torch_batch(batch(arch))
        with pytest.raises(ValueError, match="extra"):
            ttransformer.forward(model(arch), b["tokens"], mode="train")
