"""The port's ``make_train_step`` against the JAX package's, two steps.

qwen2-0.5b with ``grad_accum`` 2 and the int8 gradient compressor, and
deepseek-v3-671b (MLA, the MoE aux, MTP) with ``grad_accum`` 2, at the f32
smoke configs from the reference's weights (norms and biases perturbed,
tests/test_torch_train_common.py), AdamW at the reference's default
config: after each step the loss and every metric (``nll``, ``moe_aux``,
``mtp_loss``, ``grad_norm``, ``lr``, ``tokens``), every updated weight
and both moments within 1e-5 (rtol and atol).

At the default schedule (lr 3e-6, then 6e-6) a whole update is below that
atol, so the update itself is held too: each element's change over the
step equals the reference's within 1e-4 of lr (plus the rounding of the
new f32 weight in either package), and each moment within 1e-5 of its
leaf's largest. Left out of those two checks, counted and bounded, are
the elements whose step the rounding decides (:func:`unsettled`). Also:
``grad_accum`` 2 against one batch of the same rows, and the microbatch
split refusing a batch it does not divide.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.parallel import compression as jcomp
from repro.train import step as jstep
from repro_torch.core import tree as tree_lib
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import compression as tcomp
from repro_torch.train import step as tstep
from test_torch_train_common import (batch, jax_batch, jax_params,
                                     jax_value_and_grad, model, torch_batch,
                                     weights)

TOL = 1e-5
UPDATE_TOL = 1e-4   # of lr, on each element's change over a step
ROUNDING = 1e-4     # a gradient this small, against its leaf's largest
HALF_STEP = 1e-4    # int8: |g| this close to the middle of two grid steps
MAX_UNSETTLED = 0.02
CASES = {"qwen2-0.5b": dict(grad_accum=2, compress="int8"),
         "deepseek-v3-671b": dict(grad_accum=2, compress=None)}


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def reference_grads(arch, params, b, grad_accum):
    """The reference's gradient before the compressor and the clip: the
    mean over the microbatches of ``value_and_grad(make_loss_fn)``, numpy
    leaves in tree order."""
    vg = jax_value_and_grad(arch)
    n = b["tokens"].shape[0] // grad_accum
    per = [jax.tree_util.tree_leaves(vg(params, jax_batch(
        {k: v[i * n:(i + 1) * n] for k, v in b.items()}))[1])
        for i in range(grad_accum)]
    return [sum(np.asarray(g) for g in gs) / grad_accum for gs in zip(*per)]


def unsettled(g, compress, block=256):
    """The elements whose Adam step the rounding decides, by the reference's
    gradient ``g``: one that is not zero but within :data:`ROUNDING` of its
    leaf's largest (its own rounding error is then a share of it, and
    m̂/(√v̂ + eps) may come out anywhere in [-1, 1]); and with the int8
    compressor, an |g| within :data:`HALF_STEP` of the middle of two steps
    of its block's grid (either package may round it to either step)."""
    a = np.abs(g)
    out = (a > 0) & (a <= ROUNDING * a.max())
    if compress == "int8":
        flat = a.reshape(-1)
        blk = np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)
        x = blk / np.maximum(blk.max(axis=1, keepdims=True) / 127.0, 1e-12)
        half = np.abs(x - np.floor(x) - 0.5) < HALF_STEP
        out |= half.reshape(-1)[:g.size].reshape(g.shape)
    return out


def numpy_leaves(tree):
    return [np.array(t.detach() if isinstance(t, torch.Tensor) else t)
            for t in tree_lib.leaves(tree)]


@pytest.mark.parametrize("arch", sorted(CASES))
def test_two_train_steps_equal_jax(arch):
    case = CASES[arch]
    cfg, _, tcfg = weights(arch)
    params = jax_params(arch)
    jstate = jstep.TrainState(params=params, opt=jadamw.init(params),
                              step=jnp.zeros((), jnp.int32))
    jts = jax.jit(jstep.make_train_step(
        cfg, jadamw.Config(), grad_accum=case["grad_accum"],
        compressor=case["compress"] and jcomp.Compressor(
            mode=case["compress"])))
    tstate = tstep.init_state(model(arch))
    tts = tstep.make_train_step(
        tcfg, tadamw.Config(), grad_accum=case["grad_accum"],
        compressor=case["compress"] and tcomp.Compressor(
            mode=case["compress"]))
    flagged = None     # a step the rounding decided stays in the moments
    for s in range(2):
        b = batch(arch, s, 4)
        now = [unsettled(g, case["compress"]) for g in reference_grads(
            arch, jstate.params, b, case["grad_accum"])]
        flagged = now if flagged is None else [
            a | c for a, c in zip(flagged, now)]
        j_old = numpy_leaves(jstate.params)
        t_old = numpy_leaves(tstep.state_tree(tstate).params)
        jstate, jm = jts(jstate, jax_batch(b))
        tstate, tm = tts(tstate, torch_batch(b))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            close(tm[k] if isinstance(tm[k], torch.Tensor)
                  else np.float32(tm[k]), jm[k])
        assert int(tstate.step) == int(jstate.step) == s + 1
        ours = tstep.state_tree(tstate)
        for part in ("params", "opt"):
            ref = jax.tree_util.tree_flatten_with_path(getattr(jstate, part))[0]
            got = tree_lib.paths(getattr(ours, part))
            assert len(ref) == len(got)
            for (_, a), (key, t) in zip(ref, got):
                close(t, a)
        assert all(p.grad is None for p in tree_lib.leaves(ours.params))
        # the update: each element's change, and the moments per leaf
        lr = float(jm["lr"])
        n_out = sum(int(f.sum()) for f in flagged)
        n_all = sum(f.size for f in flagged)
        print(f"{arch} step {s + 1}: {n_out} of {n_all} elements unsettled")
        assert n_out <= MAX_UNSETTLED * n_all, (n_out, n_all)
        keys = [key for key, _ in tree_lib.paths(ours.params)]
        for key, t0, t1, a0, a1, keep in zip(
                keys, t_old, numpy_leaves(ours.params), j_old,
                numpy_leaves(jstate.params), [~f for f in flagged]):
            err = np.abs((t1 - t0) - (a1 - a0))
            tol = UPDATE_TOL * lr + 2 * np.spacing(np.abs(a1))
            assert (err <= tol)[keep].all(), \
                (key, s, float((err / lr)[keep].max()))
        for part in ("m", "v"):
            for key, t, a, keep in zip(
                    keys, numpy_leaves(getattr(ours.opt, part)),
                    numpy_leaves(getattr(jstate.opt, part)),
                    [~f for f in flagged]):
                scale = float(np.abs(a).max())
                assert (np.abs(t - a) <= TOL * (np.abs(a) + scale))[
                    keep].all(), (part, key, s)


def test_grad_accum_matches_one_batch():
    """The mean over 2 microbatches of 2 rows is the 4-row batch's loss; the
    gradients agree to rounding, so the weights within ±2 lr."""
    arch = "qwen2-0.5b"
    tcfg = weights(arch)[2]
    b = torch_batch(batch(arch, 0, 4))
    runs = []
    for ga in (1, 2):
        state = tstep.init_state(model(arch))
        state, m = tstep.make_train_step(tcfg, tadamw.Config(), ga)(state, b)
        runs.append((state, m))
    (s1, m1), (s2, m2) = runs
    close(m2["loss"], m1["loss"].numpy())
    close(m2["grad_norm"], m1["grad_norm"].numpy(), 1e-4)
    for a, c in zip(tree_lib.leaves(tstep.state_tree(s1).params),
                    tree_lib.leaves(tstep.state_tree(s2).params)):
        close(c, a.detach().numpy(), 2 * float(m1["lr"]))
    with pytest.raises(ValueError, match="microbatches"):
        tstep.make_train_step(tcfg, tadamw.Config(), 3)(
            tstep.init_state(model(arch)), b)
