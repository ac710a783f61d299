"""The builder's matvec family spread over thread-block clusters.

On the card, ``csrc/autodma_tiled.cu`` spreads a plan tile's reduction
steps over the ``ks`` blocks of one cluster: block c runs steps
c·per .. c·per + per − 1 (per = ⌈nk / ks⌉), leaves each step's f32 partial
in its shared memory, and block 0 folds them in step order with the output
rounded to the dtype after every step (unmodified ``matvec_t`` splits its
one step's rows the same way, adds the chunks in f32 and rounds once).

Here, on the CPU: the layouts (``ks``, blocks launched, shared memory, the
steps each block owns) for every mode at 2048² and at a ragged shape; the
gemm and ``center`` layouts unchanged; and the split-and-fold written out
in torch from the layout, held against the JAX ``matvec`` / ``matvec_t``
in interpret mode and the port's grid walker on the same seeded numpy
inputs. The ``cuda``-marked test holds the kernel against the walker on
the card and a graph replay against the eager call, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import autodma as tad
from repro_torch.kernels import polybench as tpb
from repro_torch.kernels import tiled

SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472         # H100: 228 KiB, 1 KiB of it reserved a block
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}   # relative Frobenius
MODES = ("autodma", "paper", "unmodified")
FULL, RAGGED = (2048, 2048), (1000, 1500)


def spec_of(name, M, N, dtype):
    if name == "matvec":
        return tad.matvec_spec(M, N, dtype=dtype)
    return tpb.matvec_t_spec(M, N, dtype=dtype)


def cluster_steps(f):
    """The reduction steps each block of a cluster runs, as the kernel
    assigns them (run_pass: s0 = rank · per)."""
    nk = f[f"ntile{f['red']}"]
    per = -(-nk // f["ks"])
    return [range(c * per, min(nk, c * per + per)) for c in range(f["ks"])]


def split_and_fold(name, plan, A, x):
    """y as the kernel computes it, written out in torch: each step's f32
    partial by the block that owns it, then block 0's fold in step order."""
    f = tiled.layout(name, plan)
    red, out = f["red"], f["out_ax1"]
    to, tr = f[f"tile{out}"], f[f"tile{red}"]
    bo, br = f[f"bound{out}"], f[f"bound{red}"]
    A2 = A if name == "matvec" else A.T       # [output, reduction]
    y = torch.empty(bo, dtype=A.dtype)
    for o0 in range(0, bo, to):
        o1 = min(bo, o0 + to)
        partial = {}
        for steps in cluster_steps(f):
            for s in steps:
                assert s not in partial
                r0, r1 = s * tr, min(br, s * tr + tr)
                partial[s] = A2[o0:o1, r0:r1].float() @ x[r0:r1].float()
        acc = torch.zeros(o1 - o0)
        for s in range(len(partial)):
            acc = acc + partial[s]
            if f["staged"]:      # the plan's steps: rounded after each
                acc = acc.to(A.dtype).float()
        y[o0:o1] = acc.to(A.dtype)
    return y


def layout_cases():
    for name in ("matvec", "matvec_t"):
        for dtype in (torch.float32, torch.bfloat16):
            for mode in MODES:
                yield name, dtype, mode, FULL
            for mode in ("autodma", "unmodified"):
                yield name, dtype, mode, RAGGED


@pytest.mark.parametrize("name,dtype,mode,shape", list(layout_cases()))
def test_layout_spreads_steps_over_a_cluster(name, dtype, mode, shape):
    plan = tad.plan(spec_of(name, *shape, dtype), mode=mode)
    f = tiled.layout(name, plan)
    nk = f[f"ntile{f['red']}"]
    steps = cluster_steps(f)
    per = len(steps[0])
    # every step belongs to exactly one block of its cluster, every block
    # runs one at least, and the cluster is the portable size at most
    assert 1 <= f["ks"] <= 8 and [s for r in steps for s in r] == \
        list(range(nk)) and all(len(r) for r in steps)
    assert per == -(-nk // 8) and f["ks"] == -(-nk // per)
    if f["staged"]:
        assert f["blocks"] == np.prod(plan.grid[:-1])   # the plan's tiles
        assert nk == plan.grid[-1]
        assert f["out_off"] == min(f["nbuf"], per) * f["stage_bytes"]
    else:   # one plan step: the kernel's own grid; only matvec_t splits it
        assert plan.grid == (1, 1)
        assert (f["ks"] > 1) == (name == "matvec_t")
    slots = nk * -(-f[f"tile{f['out_ax1']}"] // 4) * 16
    scratch = 4 * max(tiled.red_floats(e, dtype.itemsize) for e in (
        min(f[f"tile{f['out_ax1']}"], f["out_cols"]),
        f["out_cols"] % f[f"tile{f['out_ax1']}"] or 1)) \
        if name == "matvec_t" else 0
    assert f["smem"] == f["out_off"] + slots + scratch <= SMEM_PER_BLOCK
    if shape == FULL:
        assert f["blocks"] * f["ks"] >= 128
        if f["staged"] and per == 1:   # one buffer: three blocks an SM
            assert 3 * (f["smem"] + 1024) <= SMEM_PER_SM


def test_layout_at_2048_matches_the_design():
    """autodma f32: 32 tiles x 8 blocks of one 66.5 KB step; paper: 16 x 8
    of two steps, single-buffered; unmodified matvec_t: 64 column tiles of
    32 columns x 4 chunks of 512 rows; unmodified matvec: 8 rows a block."""
    got = {}
    for name in ("matvec", "matvec_t"):
        for mode in MODES:
            f = tiled.layout(name, tad.plan(spec_of(name, *FULL,
                                                    torch.float32), mode=mode))
            got[name, mode] = (f["blocks"], f["ks"], len(cluster_steps(f)[0]))
    assert got == {("matvec", "autodma"): (32, 8, 1),
                   ("matvec", "paper"): (16, 8, 2),
                   ("matvec", "unmodified"): (256, 1, 1),
                   ("matvec_t", "autodma"): (32, 8, 1),
                   ("matvec_t", "paper"): (16, 8, 2),
                   ("matvec_t", "unmodified"): (64, 4, 1)}
    f = tiled.layout("matvec_t", tad.plan(spec_of("matvec_t", *FULL,
                                                  torch.float32),
                                          mode="unmodified"))
    assert (f["tile0"], f["tile1"]) == (32, 512)


# fields of the gemm and center layouts as the builder had them before the
# matvec family took clusters: (blocks, threads, smem, out_off,
# stage_bytes, fpw, npass, ntile0, ntile1, ntile2)
KEEP = [
    ("gemm_mxu", "autodma", tad.matmul_spec(2048, 2048, 2048),
     (1024, 256, 141312, 141312, 70656, 1, 1, 32, 32, 16)),
    ("gemm_vpu", "unmodified", tad.matmul_spec(2048, 2048, 2048),
     (1024, 256, 0, 0, 0, 1, 1, 32, 32, 1)),
    ("gemm_mxu", "paper", tad.matmul_spec(2048, 2048, 2048,
                                          dtype=torch.bfloat16),
     (256, 256, 69632, 69632, 69632, 4, 1, 16, 16, 16)),
    ("gram", "autodma", tpb.gram_spec(2048, 2048),
     (1024, 256, 147456, 147456, 73728, 1, 1, 32, 32, 16)),
    ("center", "autodma", tad.elementwise_spec((2048, 2048), n_in=2,
                                               name="center"),
     (512, 256, 131072, 131072, 65536, 0, 1, 128, 4, 1)),
]


@pytest.mark.parametrize("body,mode,spec,fields", KEEP,
                         ids=[f"{b}-{m}" for b, m, _, _ in KEEP])
def test_gemm_and_center_layouts_keep_one_block_a_tile(body, mode, spec,
                                                       fields):
    f = tiled.layout(body, tad.plan(spec, mode=mode))
    assert f["ks"] == 1
    assert tuple(f[k] for k in ("blocks", "threads", "smem", "out_off",
                                "stage_bytes", "fpw", "npass", "ntile0",
                                "ntile1", "ntile2")) == fields


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_reference(name, plan, A, x, dtype):
    """The JAX body (``repro/kernels/polybench.py``) run by the JAX builder
    in interpret mode over a plan of the port's tiles, so that both fold
    the same steps (bf16 rounds after each). Inputs are zero-padded to
    whole tiles: interpret mode reads NaN past a ragged edge, and zeros
    add nothing to a partial."""
    import jax.numpy as jnp
    from repro.core import autodma as jad
    from repro.kernels import gemm as jgemm
    from repro.kernels import polybench as jpb

    def matvec_t_body(a_ref, x_ref, y_ref, axis_info):  # polybench.py:52
        jidx, _ = axis_info[1]
        prev = jnp.where(jidx == 0, jnp.zeros_like(y_ref[...]), y_ref[...])
        y_ref[...] = prev + a_ref[...].T @ x_ref[...]

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    (bo, br), (to, tr) = plan.spec.loop_bounds, plan.tiles
    po, pr = -(-bo // to) * to, -(-br // tr) * tr
    Ap = np.zeros((po, pr) if name == "matvec" else (pr, po), np.float32)
    Ap[:A.shape[0], :A.shape[1]] = A
    xp = np.zeros(pr, np.float32)
    xp[:len(x)] = x
    if name == "matvec":
        spec, body = jad.matvec_spec(po, pr, dtype=jdt), jpb._matvec_body
    else:
        spec, body = jad.KernelSpec(
            name="matvec_t", loop_bounds=(po, pr), reduction_axes=(1,),
            flops_per_point=2, arrays=(
                jad.ArrayAccess("A", (pr, po), (1, 0), jdt),
                jad.ArrayAccess("x", (pr,), (1,), jdt),
                jad.ArrayAccess("y", (po,), (0,), jdt, is_output=True))), \
            matvec_t_body
    call, _ = jad.pallas_call(body, spec, interpret=True,
                              plan_=jgemm._plan_with_tiles(spec, plan.tiles,
                                                           None))
    return np.asarray(call(jnp.asarray(Ap, jdt), jnp.asarray(xp, jdt)),
                      np.float32)[:bo]


# (shape, planner budget): small budgets give the plans several steps and
# ragged tiles (200 x 300: 10 steps of 32, the last of 12); None is the
# H100 budget (ragged 1000 x 1500: autodma's (32, 32) tiles, 47 steps, 6 a
# block of a cluster of 8)
ARITH = [((256, 384), 64 * 1024), ((200, 300), 32 * 1024),
         (RAGGED, None), (FULL, None)]


@pytest.mark.parametrize("shape,budget", ARITH,
                         ids=[f"{m}x{n}" for (m, n), _ in ARITH])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["matvec", "matvec_t"])
def test_split_and_fold_matches_jax_and_the_walker(name, dtype, shape,
                                                   budget):
    M, N = shape
    rng = np.random.default_rng(M + N + (name == "matvec_t"))
    A = rng.standard_normal((M, N)).astype(np.float32)
    x = rng.standard_normal(N if name == "matvec" else M).astype(np.float32)
    tA, tx = (torch.from_numpy(a).to(dtype) for a in (A, x))
    fn = getattr(tpb, name)
    ran = 0
    for mode in MODES:
        walked, plan = fn(tA, tx, mode=mode, budget=budget)
        try:
            tiled.layout(name, plan)
        except ValueError:   # paper's whole axes at a ragged shape
            assert mode == "paper" and shape in ((200, 300), RAGGED)
            continue
        ran += 1
        y = split_and_fold(name, plan, tA, tx)
        assert y.dtype == dtype and y.shape == walked.shape
        assert _rel(y.float(), jax_reference(name, plan, A, x, dtype)) <= \
            TOL[dtype], (mode, "jax")
        assert _rel(y.float(), walked.float()) <= TOL[dtype], \
            (mode, "walker")
    assert ran >= 2


@pytest.mark.cuda
def test_cuda_matvec_split_matches_walker_and_replays():
    """On the card: matvec and matvec_t in every mode, f32 and bf16, at
    2048² and a ragged shape, against the grid walker on the same CUDA
    tensors (relative Frobenius f32 1e-5, bf16 1e-2), one launch a call;
    a call captured in a CUDA graph and replayed twice equals the eager
    call bit for bit (no atomics, nothing left to reset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_matvec_split.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    bodies = {"matvec": tpb._matvec_body, "matvec_t": tpb._matvec_t_body}
    for (M, N), dt, modes in ((FULL, torch.float32, MODES),
                              (FULL, torch.bfloat16, MODES),
                              (RAGGED, torch.float32, MODES[::2]),
                              ((200, 170), torch.bfloat16, MODES)):
        A = torch.randn(M, N, generator=g, device="cuda").to(dt)
        for name in ("matvec", "matvec_t"):
            fn = getattr(tpb, name)
            v = torch.randn(N if name == "matvec" else M, generator=g,
                            device="cuda").to(dt)
            for mode in modes:
                n0 = (fn.launches, tiled.launch.launches)
                y, plan = fn(A, v, mode=mode)
                torch.cuda.synchronize()
                assert (fn.launches, tiled.launch.launches) == (
                    n0[0] + 1, n0[1] + 1)
                plain = tad.walk(bodies[name], plan, A, v)
                err = ((y.float() - plain.float()).norm()
                       / plain.float().norm()).item()
                assert err <= TOL[dt], (name, M, dt, mode, err)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    yg, _ = fn(A, v, mode=mode)
                for _ in range(2):
                    graph.replay()
                    torch.cuda.synchronize()
                    assert torch.equal(yg, y), (name, M, dt, mode)
