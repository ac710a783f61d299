"""The train-mode forward and its loss gradient against the JAX package:
qwen2-0.5b, yi-34b, minitron-4b, gemma3-27b (sliding-window ``local``
layers, sandwich and zero-centred norms, a scaled embedding) and
granite-moe-3b-a800m (the capacity-dispatched MoE and its aux loss).

At each arch's f32 smoke config, with the reference's ``PRNGKey(0)``
weights (norm scales and biases perturbed) carried across by
``models/convert.py`` and a ``make_batch`` batch:

  * ``transformer.forward(model, tokens, mode="train")``: logits and
    ``moe_aux`` against JAX's ``forward(mode="train")``, within 1e-5
    (``tol · max|ref|`` absolute beside ``tol`` relative);
  * the loss and every leaf's gradient (``make_loss_fn`` and
    ``backward``) against ``jax.value_and_grad(make_loss_fn(cfg))``,
    within 1e-5 (absolute part scaled by the largest gradient);
  * ``remat="none"`` gives the gradients of ``remat="full"`` (the
    checkpointed units recompute what they dropped);
  * ``mode="train"`` takes no caches, and the weights keep their f32
    dtype while the compute dtype is bf16 (the casts sit in the forward).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.models import transformer as ttransformer
from repro_torch.train import step as tstep
from test_torch_train_common import (batch, close_scaled, jax_batch,
                                     jax_forward, jax_params,
                                     jax_value_and_grad, model, tol,
                                     torch_batch, weights)

ARCHS = ("qwen2-0.5b", "yi-34b", "minitron-4b", "gemma3-27b",
         "granite-moe-3b-a800m")


def check_forward(arch):
    b = batch(arch)
    jl, jaux = jax_forward(arch)(jax_params(arch), jax_batch(b))
    tb = torch_batch(b)
    with torch.no_grad():
        tl, taux = ttransformer.forward(
            model(arch), tb["tokens"], mode="train", extra=tb.get("extra"),
            next_tokens=tb.get("next_tokens"))
    close_scaled(tl, jl, tol(arch))
    close_scaled(taux["moe_aux"], jaux["moe_aux"], tol(arch))
    assert sorted(taux) == sorted(jaux)
    if "mtp_logits" in jaux:
        close_scaled(taux["mtp_logits"], jaux["mtp_logits"], tol(arch))
    return tl


def grads_of(m, arch):
    tstep.init_state(m)
    loss, metrics = tstep.make_loss_fn(m.cfg)(m, torch_batch(batch(arch)))
    loss.backward()
    return loss, metrics, [p.grad for p in tree_lib.leaves(
        ttransformer.param_tree(m))]


def check_grads(arch):
    (jloss, jmets), jg = jax_value_and_grad(arch)(jax_params(arch),
                                                  jax_batch(batch(arch)))
    m = model(arch)
    loss, metrics, grads = grads_of(m, arch)
    close_scaled(loss, jloss, tol(arch))
    assert sorted(metrics) == sorted(jmets)
    for k in jmets:
        close_scaled(metrics[k], jmets[k], tol(arch))
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = tree_lib.paths(ttransformer.param_tree(m))
    assert len(jflat) == len(paths)
    gmax = max(float(np.abs(np.asarray(g)).max()) for _, g in jflat)
    for (jpath, ref), (key, _), got in zip(jflat, paths, grads):
        assert key == "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                               for p in jpath)
        assert got is not None and got.dtype == torch.float32, key
        close_scaled(got, ref, tol(arch), scale=gmax)
    # the same gradients with no remat
    _, _, plain = grads_of(model(arch, remat="none"), arch)
    for got, ref in zip(plain, grads):
        close_scaled(got, ref.numpy(), 1e-6, scale=gmax)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_equals_jax(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_equals_jax(arch):
    check_grads(arch)


def test_train_mode_takes_no_caches_and_keeps_master_weights():
    m = model("qwen2-0.5b", compute_dtype=torch.bfloat16)
    caches = ttransformer.init_caches(m.cfg, 1, 8)
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="mode 'train'"):
        ttransformer.forward(m, toks, caches, 0, "train")
    loss, _, grads = grads_of(m, "qwen2-0.5b")
    assert m.embed.dtype == torch.float32 and torch.isfinite(loss)
    assert all(g.dtype == torch.float32 for g in grads)
