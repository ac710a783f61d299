"""The port's conv2d and covar (and the builder's center and gram bodies)
against the JAX package.

Inputs are made with numpy from a seed and go through both packages: the
JAX Pallas kernels in interpret mode (as tests/test_kernels.py runs them,
at its sizes, its 512 KiB budget and its tolerances: conv2d rtol 2e-4,
covar 2e-3) and the port's functions on CPU tensors, which take the plain
versions (conv2d's row-tile walk; the builder's grid walker with the
center and gram bodies). The ``cuda``-marked test at the end holds the
CUDA kernels against those plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm as jgemm
from repro.kernels import ops as jops
from repro.kernels import polybench as jpb
from repro.kernels import ref as jref
from repro_torch.core import autodma as tad
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops
from repro_torch.kernels import polybench as tpb
from repro_torch.kernels import tiled

BUDGET = 512 * 1024  # the JAX tests' budget: multi-block grids at test sizes
CONV_TOL = dict(rtol=2e-4, atol=2e-4)
COVAR_TOL = dict(rtol=2e-3, atol=2e-3)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("H,W", [(64, 128), (128, 256), (96, 128)])
@pytest.mark.parametrize("row_tile", [32, None])
def test_conv2d_matches_jax(H, W, row_tile):
    rng = np.random.default_rng(H + W)
    A, c = rand(rng, H, W), rand(rng, 3, 3)
    out, plan = tpb.conv2d(*_t(A, c), budget=BUDGET, row_tile=row_tile)
    jout, jplan = jpb.conv2d(A, c, budget=BUDGET, row_tile=row_tile)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **CONV_TOL)
    np.testing.assert_allclose(out.numpy(), jref.conv2d(A, c), **CONV_TOL)
    assert plan.spec.name == jplan.spec.name == "conv2d"
    assert plan.mode == jplan.mode == "autodma"


def test_conv2d_bf16_matches_jax():
    """bf16 in and out, f32 accumulation on both sides: they may differ by
    one bf16 rounding step of the value (2^-8 relative)."""
    rng = np.random.default_rng(5)
    A = jnp.asarray(rand(rng, 64, 128), jnp.bfloat16)
    c = rand(rng, 3, 3)
    out, _ = tpb.conv2d(torch.from_numpy(np.asarray(A, np.float32))
                        .bfloat16(), torch.from_numpy(c), row_tile=16)
    jout, _ = jpb.conv2d(A, c, row_tile=16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), rtol=2**-8,
                               atol=2e-3)


def test_conv2d_tiles_and_modes():
    """The row tile follows the reference's rule at the port's L1 capacity
    (8 rows at W 2048, shrunk until it divides H); the kernel tiles for
    itself in bands of whole 16-byte lanes, whatever the row tile, so a row
    tile of any height is taken (the reference takes any); the mode changes
    only the plan."""
    assert tpb.conv2d_row_tile(2048, 2048) == 8
    assert tpb.conv2d_row_tile(1001, 1500) == 7
    assert tpb.conv2d_row_tile(96, 128, 32) == 32
    assert tpb.conv2d_row_tile(100, 128, 32) == 25
    assert tpb.conv2d_launch(2048, 2048) == (4, 16, 4, 128, 512)
    assert tpb.conv2d_launch(2048, 2048, torch.bfloat16) == (8, 8, 2, 256,
                                                             512)
    assert tpb.conv2d_launch(100, 128).vec == 4
    assert tpb.conv2d_launch(4096, 4096).band == 16    # no row tile in it
    rng = np.random.default_rng(8)
    A, c = _t(rand(rng, 48, 40), rand(rng, 3, 3))
    out, _ = tpb.conv2d(A, c, row_tile=48)   # a whole-image row tile
    np.testing.assert_allclose(out.numpy(), jref.conv2d(A.numpy(),
                                                        c.numpy()),
                               **CONV_TOL)
    rng = np.random.default_rng(6)
    A, c = _t(rand(rng, 64, 96), rand(rng, 3, 3))
    outs = {}
    for mode in ("unmodified", "paper", "autodma"):
        outs[mode], plan = tpb.conv2d(A, c, mode=mode)
        assert plan.mode == mode
        jplan = jpb.conv2d(np.asarray(A), np.asarray(c), mode=mode)[1]
        assert jplan.mode == mode
    assert torch.equal(outs["paper"], outs["unmodified"])
    assert torch.equal(outs["autodma"], outs["unmodified"])


CONV_BAND_SHAPES = [(2048, 2048, torch.float32), (2048, 2048, torch.bfloat16),
                    (1001, 1500, torch.float32), (1001, 1500, torch.bfloat16),
                    (37, 333, torch.float32), (64, 256, torch.float32),
                    (1, 1, torch.float32), (1, 1, torch.bfloat16)]


@pytest.mark.parametrize("H,W,dtype", CONV_BAND_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_conv2d_bands_cover_every_output_once(H, W, dtype, aligned):
    """The kernel's index math written out: block (bx, by), warp w, lane l
    writes columns (bx·WARPS + w)·32·vec + l·vec .. + vec − 1 of rows
    by·band .. by·band + band − 1, inside the image; every output is written
    exactly once. A lane's 16-byte vector lies wholly inside or outside a
    row (vec divides W), and a ragged W, or rows that do not start 16-byte
    aligned, take the scalar path (vec 1)."""
    shape = tpb.conv2d_launch(H, W, dtype, aligned)
    full = 16 // torch.empty(0, dtype=dtype).element_size()
    assert shape.vec == (full if aligned and W % full == 0 else 1)
    assert shape.band % tpb.CONV_DEPTH == 0
    assert shape.band >= tpb.CONV_BAND[dtype]
    assert shape.grid_y <= tpb.CONV_MAX_GRID_Y
    lanes = shape.grid_x * tpb.CONV_WARPS * 32
    first = np.arange(lanes) * shape.vec          # a lane's first column
    assert (first[first < W] + shape.vec <= W).all()
    cols = np.zeros(W, np.int64)
    for j in range(shape.vec):
        np.add.at(cols, first[first + j < W] + j, 1)
    rows = np.zeros(H, np.int64)
    for by in range(shape.grid_y):
        rows[by * shape.band:min(H, (by + 1) * shape.band)] += 1
    assert (cols == 1).all() and (rows == 1).all()
    assert shape.blocks == shape.grid_x * shape.grid_y
    assert (shape.grid_x - 1) * tpb.CONV_WARPS * 32 * shape.vec < W


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_plain_bits_do_not_depend_on_the_row_tile(dtype):
    """Every output is the same nine products summed in the same order
    whatever the row tile: conv2d_plain gives the same bits for row tiles
    1, 7, 8, 25 and H, so the kernel may walk bands of its own height."""
    rng = np.random.default_rng(9)
    H, W = 1400, 33               # 1400 = 7 · 8 · 25: every tile divides it
    A = torch.from_numpy(rand(rng, H, W)).to(dtype)
    c = torch.from_numpy(rand(rng, 3, 3))
    ref = tpb.conv2d_plain(A, c, H)
    for bh in (1, 7, 8, 25):
        assert torch.equal(tpb.conv2d_plain(A, c, bh), ref), bh


@pytest.mark.parametrize("mode", ["autodma", "paper", "unmodified"])
def test_covar_matches_jax(mode):
    rng = np.random.default_rng(7)
    D = rand(rng, 256, 128)
    out, (p1, p2) = tpb.covar(*_t(D), mode=mode, budget=BUDGET)
    jout, (jp1, jp2) = jpb.covar(D, mode=mode, budget=BUDGET)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **COVAR_TOL)
    np.testing.assert_allclose(out.numpy(), jref.covar(D), **COVAR_TOL)
    assert torch.equal(tpb.covar_plain(*_t(D), p1, p2), out)
    for tp, jp in ((p1, jp1), (p2, jp2)):
        assert tp.spec.name == jp.spec.name and tp.mode == jp.mode
        assert [a.dims for a in tp.spec.arrays] == \
            [a.dims for a in jp.spec.arrays]
        assert tp.spec.loop_bounds == jp.spec.loop_bounds
        assert tp.spec.reduction_axes == jp.spec.reduction_axes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["autodma", "paper", "unmodified"])
def test_center_and_gram_layouts(dtype, mode):
    """covar's two plans at N=2048 (bench_tiling's shape) as the kernel's
    fields: center is a reduction-free spec run as one step over a virtual
    axis of bound 1; gram reads D1 through (k, i), its staged rows skewed
    for reads down the columns (by dtype); both fit a block's shared
    memory."""
    N = 2048
    p1 = tad.plan(tad.elementwise_spec((N, N), n_in=2, dtype=dtype,
                                       name="center"), mode=mode)
    f = tiled.layout("center", p1)
    assert (f["body"], f["red"], f["bound2"], f["tile2"], f["ntile2"]) == (
        tiled.BODIES["center"], 2, 1, 1, 1)
    assert (f["par0"], f["par1"], f["threads"], f["npass"]) == (0, 1, 256, 1)
    assert (f["in0_ax0"], f["in0_ax1"], f["in1_ax0"], f["in1_ax1"]) == (
        0, 1, 0, 1)
    assert f["staged"] == (mode != "unmodified") and f["smem"] <= 232_448
    if mode == "unmodified":   # the kernel's own 64 x 64 tiles, unstaged
        assert (f["tile0"], f["tile1"], f["blocks"]) == (64, 64, 1024)
    else:
        assert f["blocks"] == np.prod(p1.grid)
        assert f["in0_pcol"] % 8 == 0 and f["in1_soff"] % 16 == 0
    p2 = tad.plan(tpb.gram_spec(N, N, dtype), mode=mode)
    f = tiled.layout("gram", p2)
    assert f["body"] == tiled.BODIES["gram"] and f["red"] == 2
    assert (f["in0_ax0"], f["in0_ax1"], f["in1_ax0"], f["in1_ax1"]) == (
        2, 0, 2, 1)
    assert f["smem"] <= 232_448 and f["threads"] <= 512
    if f["staged"]:
        # row skew for reads down the columns: f32 8 words (a 32-bit element
        # a lane), bf16 16 bytes (ldmatrix.trans rows)
        item, skew = dtype.itemsize, (32 if dtype == torch.float32 else 16)
        assert (f["in0_ld"] - f["in0_pcol"]) * item == skew
        assert (f["in1_ld"] - f["in1_pcol"]) * item == skew
        assert f["in0_prow"] % 16 == 0 and f["in0_pcol"] % 32 == 0


def test_builder_refuses_what_center_and_gram_do_not_fit():
    gemm_plan = tad.plan(tad.matmul_spec(256, 256, 256))
    gram_plan = tad.plan(tpb.gram_spec(256, 128))
    center_plan = tad.plan(tad.elementwise_spec((256, 128), n_in=2))
    with pytest.raises(ValueError, match="0 reduction axis"):
        tiled.layout("center", gemm_plan)
    with pytest.raises(ValueError, match="1 reduction axis"):
        tiled.layout("gram", center_plan)
    with pytest.raises(ValueError, match="does not fit the axis maps"):
        tiled.layout("gram", gemm_plan)
    with pytest.raises(ValueError, match="does not fit the axis maps"):
        tiled.layout("gemm_mxu", gram_plan)
    one_in = tad.plan(tad.elementwise_spec((256, 128), n_in=1))
    with pytest.raises(ValueError, match="needs 2 inputs"):
        tiled.layout("center", one_in)
    # the gemm layouts keep their skews: A read along rows, B down columns
    f = tiled.layout("gemm_mxu", gemm_plan)
    assert f["in0_ld"] - f["in0_pcol"] == 4 and \
        f["in1_ld"] - f["in1_pcol"] == 8


def test_ops_surface_and_refs_match_jax():
    rng = np.random.default_rng(8)
    A, c, D = rand(rng, 64, 96), rand(rng, 3, 3), rand(rng, 96, 64)
    tA, tc, tD = _t(A, c, D)
    assert set(ops.REFS) == set(jops.REFS)
    np.testing.assert_allclose(ops.REFS["conv2d"](tA, tc).numpy(),
                               jref.conv2d(A, c), **CONV_TOL)
    np.testing.assert_allclose(ops.REFS["covar"](tD).numpy(),
                               jref.covar(D), **COVAR_TOL)
    for mode in ("autodma", "paper", "unmodified"):
        np.testing.assert_allclose(ops.conv2d(tA, tc, mode=mode).numpy(),
                                   ops.REFS["conv2d"](tA, tc).numpy(),
                                   **CONV_TOL)
        np.testing.assert_allclose(ops.covar(tD, mode=mode).numpy(),
                                   ops.REFS["covar"](tD).numpy(),
                                   **COVAR_TOL)
    before = (tpb.conv2d.launches, tpb.covar.launches, tiled.launch.launches)
    ops.conv2d(tA, tc)
    ops.covar(tD)
    assert (tpb.conv2d.launches, tpb.covar.launches,
            tiled.launch.launches) == before


@pytest.mark.parametrize("K,tk", [(40, 20), (30, 30)])
def test_loop_body_keeps_the_k_remainder_the_reference_drops(K, tk):
    """The JAX ``loop`` body runs ``fori_loop(0, Kb // 8, ...)`` over each
    k-step (repro/kernels/gemm.py:54) and so drops the last Kb % 8 slices
    of every step whose depth is not a multiple of 8; the port's body keeps
    them. Pinned: the port equals the oracle, and the reference differs
    from it by exactly the product over the dropped slices."""
    rng = np.random.default_rng(K)
    M, N = 32, 48
    A, B = rand(rng, M, K), rand(rng, K, N)
    out, plan = tgemm.gemm(*_t(A, B), body="loop",
                           handwritten_tiles=(M, N, tk))
    jout, jplan = jgemm.gemm(A, B, body="loop", handwritten_tiles=(M, N, tk))
    assert plan.tiles == jplan.tiles == (M, N, tk)
    np.testing.assert_allclose(out.numpy(), jref.gemm(A, B), rtol=2e-4,
                               atol=2e-4)
    kept = np.concatenate([np.arange(s, s + tk // 8 * 8)
                           for s in range(0, K, tk)])
    dropped = np.setdiff1d(np.arange(K), kept)
    assert len(dropped) == (K // tk) * (tk % 8) > 0
    np.testing.assert_allclose(np.asarray(jout), A[:, kept] @ B[kept],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy() - np.asarray(jout),
                               A[:, dropped] @ B[dropped], rtol=2e-4,
                               atol=2e-4)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_cuda_conv2d_and_covar_match_their_plain_versions():
    """On the card: conv2d (f32 and bf16, ragged shapes on the vector and
    the scalar path, every mode) and covar (every mode) against their plain
    versions on the same tensors, each launch counted. conv2d equals its
    plain version bit for bit (the same products and sums, rounded one by
    one, then one rounding to the dtype); covar within a relative Frobenius
    error of 5e-3 (the gram's operands rounded to TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_polybench.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    c = torch.randn(3, 3, generator=g, device="cuda")
    for (H, W), dt in (((512, 384), torch.float32),
                       ((1001, 1500), torch.float32),
                       ((999, 1001), torch.float32),
                       ((1001, 1500), torch.bfloat16),
                       ((512, 384), torch.bfloat16)):
        A = torch.randn(H, W, generator=g, device="cuda").to(dt)
        for mode in ("autodma", "paper", "unmodified"):
            n0 = tpb.conv2d.launches
            out, _ = tpb.conv2d(A, c, mode=mode)
            torch.cuda.synchronize()
            assert tpb.conv2d.launches == n0 + 1
            plain = tpb.conv2d_plain(A, c, tpb.conv2d_row_tile(H, W))
            assert torch.equal(out, plain), (H, W, dt, mode)
    # ragged: no tile divides 600 x 300, so autodma degrades to granule
    # tiles (short last blocks); paper's rule falls back to whole axes,
    # which shared memory cannot hold, and raises
    for (M, N), modes in (((512, 384), ("autodma", "paper", "unmodified")),
                          ((600, 300), ("autodma", "unmodified"))):
        D = torch.randn(M, N, generator=g, device="cuda")
        for mode in modes:
            n0 = (tpb.covar.launches, tiled.launch.launches)
            out, _ = tpb.covar(D, mode=mode)
            torch.cuda.synchronize()
            assert (tpb.covar.launches, tiled.launch.launches) == (
                n0[0] + 1, n0[1] + 2)
            plain, _ = tpb.covar(D.cpu(), mode=mode)
            assert _rel(out.cpu(), plain) <= 5e-3, (M, N, mode)
    with pytest.raises(ValueError, match="may use 232448"):
        tpb.covar(D, mode="paper")
