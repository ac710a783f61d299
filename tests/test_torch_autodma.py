"""The port's AutoDMA planner, heromem and builder layout against the JAX
package.

The planner is a copy: under the TPU's granules (patched into the port's
``heromem``, which the planner reads at call time) it gives the JAX
planner's tiles, grid, block shapes and accounting exactly. Under the port's
own H100 constants every plan the kernel suite makes fits the 232,448 bytes
of shared memory a block may use, and the builder's layout of it is valid.
The CUDA builder itself is held against the plain grid walker on the card
by the ``cuda``-marked test in tests/test_torch_suite.py and by
chip_smoke.py.
"""
import itertools
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autodma as jad
from repro.core import heromem as jhm
from repro.kernels import gemm as jgemm
from repro_torch.core import autodma as tad
from repro_torch.core import heromem as thm
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import polybench as tpb
from repro_torch.kernels import tiled
from repro_torch.launch.kernel_suite import HANDWRITTEN_TILES

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
BUDGET = 512 * 1024
DT = {np.float32: (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _matvec_t_jax(M, N, dtype):
    return jad.KernelSpec(
        name="matvec_t", loop_bounds=(N, M), reduction_axes=(1,),
        flops_per_point=2,
        arrays=(jad.ArrayAccess("A", (M, N), (1, 0), dtype),
                jad.ArrayAccess("x", (M,), (1,), dtype),
                jad.ArrayAccess("y", (N,), (0,), dtype, is_output=True)))


SPECS = {
    "gemm_128": lambda m, d: m.matmul_spec(128, 128, 128, dtype=d),
    "gemm_256x384x512": lambda m, d: m.matmul_spec(256, 384, 512, dtype=d),
    "gemm_8x128x256": lambda m, d: m.matmul_spec(8, 128, 256, dtype=d),
    "gemm_136": lambda m, d: m.matmul_spec(136, 128, 128, dtype=d),
    "gemm_2048": lambda m, d: m.matmul_spec(2048, 2048, 2048, dtype=d),
    "darknet": lambda m, d: m.matmul_spec(1024, 1024, 4608, dtype=d),
    "matvec_2048": lambda m, d: m.matvec_spec(2048, 2048, dtype=d),
    "matvec_512x384": lambda m, d: m.matvec_spec(512, 384, dtype=d),
    "matvec_t_2048": lambda m, d: (_matvec_t_jax(2048, 2048, d) if m is jad
                                   else tpb.matvec_t_spec(2048, 2048, d)),
    "matvec_t_512x384": lambda m, d: (_matvec_t_jax(512, 384, d) if m is jad
                                      else tpb.matvec_t_spec(512, 384, d)),
    "eltwise": lambda m, d: m.elementwise_spec((256, 512), n_in=2, dtype=d),
    "conv2d": lambda m, d: m.conv2d_3x3_spec(2048, 2048, dtype=d),
}
FIELDS = ("tiles", "grid", "grid_axes", "block_shapes", "traffic_bytes",
          "vmem_bytes", "dma_bursts", "dma_reconfigs", "mode", "flops")


@pytest.fixture
def tpu_granules(monkeypatch):
    monkeypatch.setattr(thm, "LANE", jhm.LANE)
    monkeypatch.setattr(thm, "SUBLANE", dict(jhm.SUBLANE))


def _same_plan(tp, jp):
    for f in FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    for name in jp.block_shapes:
        for pids in [(0,) * len(jp.grid), tuple(n - 1 for n in jp.grid)]:
            assert tuple(tp.index_maps[name](*pids)) == tuple(
                int(i) for i in jp.index_maps[name](*pids))


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("mode", ["autodma", "paper", "unmodified"])
@pytest.mark.parametrize("dt", [np.float32, "bf16"], ids=["f32", "bf16"])
def test_plan_equals_jax_under_tpu_granules(tpu_granules, name, mode, dt):
    jd, td = DT[dt]
    for budget, contiguous in [(BUDGET, False), (1 << 20, True)]:
        jp = jad.plan(SPECS[name](jad, jd), budget=budget, mode=mode,
                      assume_contiguous=contiguous)
        tp = tad.plan(SPECS[name](tad, td), budget=budget, mode=mode,
                      assume_contiguous=contiguous)
        _same_plan(tp, jp)


@pytest.mark.parametrize("tiles", [(128, 128, 256), (48, 80, 96)])
def test_handwritten_plan_equals_jax(tpu_granules, tiles):
    jp = jgemm._plan_with_tiles(jad.matmul_spec(256, 256, 256), tiles, None)
    tp = tgemm._plan_with_tiles(tad.matmul_spec(256, 256, 256), tiles)
    _same_plan(tp, jp)


def test_heromem_allocator_matches_jax():
    """The o1heap model: one sequence of mallocs and frees gives the same
    handles and capacities on both sides."""
    j, t = jhm.SpmLevel("j", 1 << 16), thm.SpmLevel("t", 1 << 16)
    handles = []
    for n in [100, 2000, 8, 4096, 300, 30000, 5]:
        hj, ht = j.malloc(n), t.malloc(n)
        assert hj == ht and j.capacity() == t.capacity()
        handles.append(hj)
    for h in handles[1::2]:
        j.free(h)
        t.free(h)
        assert j.capacity() == t.capacity() and j.in_use() == t.in_use()
    assert [j.can_alloc(n) for n in (1, 2000, 40000)] == \
        [t.can_alloc(n) for n in (1, 2000, 40000)]
    assert thm.fragment_size(100) == jhm.fragment_size(100)
    t.smash_canary(handles[0])
    with pytest.raises(thm.HeapOverflow):
        t.free(handles[0])
    assert thm.paper_tile_side(3, 2, capacity_words=28 * 1024) == \
        jhm.paper_tile_side(3, 2, capacity_words=28 * 1024)


def test_h100_constants():
    assert thm.SMEM_PER_BLOCK == 232_448
    assert thm.hero_l1_capacity() == 232_448 - thm.SMEM_RESERVE - 8
    assert thm.LANE == 32 and set(thm.SUBLANE.values()) == {16}
    assert thm.aligned_tile(100, 4, True) == 96
    assert thm.aligned_tile(100, 2, False) == 96
    assert thm.aligned_tile(5, 4, False) == 16


# the kernel suite's shapes and the handwritten tiles it runs
SUITE = [tad.matmul_spec(2048, 2048, 2048), tad.matmul_spec(1024, 1024, 4608),
         tad.matmul_spec(512, 512, 512), tad.matmul_spec(256, 256, 1152),
         tad.matmul_spec(384, 384, 384), tad.matvec_spec(2048, 2048),
         tpb.matvec_t_spec(2048, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["autodma", "paper", "unmodified"])
def test_suite_plans_fit_shared_memory(dtype, mode):
    for s in SUITE:
        spec = tad.KernelSpec(s.name, s.loop_bounds, tuple(
            tad.ArrayAccess(a.name, a.shape, a.dims, dtype, a.is_output)
            for a in s.arrays), s.reduction_axes, s.flops_per_point)
        p = tad.plan(spec, mode=mode)
        if mode != "unmodified":
            assert p.vmem_bytes <= 232_448, (spec.name, p.tiles)
        gemm = len(spec.arrays[1].shape) == 2
        names = tiled.GEMM_BODIES if gemm else [
            "matvec_t" if spec.arrays[0].dims == (1, 0) else "matvec"]
        plans = [p]
        if gemm:
            plans.append(tgemm._plan_with_tiles(spec, HANDWRITTEN_TILES))
        for body, p in itertools.product(names, plans):
            f = tiled.layout(body, p)
            assert f["smem"] <= 232_448 and f["threads"] <= 512
            assert f["staged"] == (p.mode != "unmodified")
            assert f["nbuf"] == (1 if p.mode == "paper" else 2)
            if f["staged"]:
                assert f["blocks"] == np.prod(p.grid[:-1])


def test_layout_fields_and_refusals():
    from repro_torch.kernels.gemm import _plan_with_tiles
    spec = tad.matmul_spec(200, 300, 170)
    f = tiled.layout("gemm_mxu", _plan_with_tiles(spec, (64, 128, 64)))
    assert len(tiled.FIELDS) == 46 and set(f) == set(tiled.FIELDS)
    # ragged: 4 x 3 blocks, tiles padded to the fragment granules
    assert (f["blocks"], f["ntile2"], f["nrg"], f["ncg"]) == (12, 3, 4, 4)
    assert f["in0_prow"] == 64 and f["in0_pcol"] == 64
    assert f["in0_ld"] % 32 == 4 and f["in1_ld"] % 32 == 8
    assert f["in1_soff"] % 16 == 0 and f["nbuf"] == 2
    # matvec_t reads A [M, N] through dims (1, 0)
    p = tad.plan(tpb.matvec_t_spec(512, 384), mode="paper")
    f = tiled.layout("matvec_t", p)
    assert (f["in0_ax0"], f["in0_ax1"], f["in1_ax0"]) == (1, 0, -1)
    assert (f["in0_prow"], f["in0_pcol"], f["in0_ld"]) == (128, 128, 128)
    f = tiled.layout("matvec", tad.plan(tad.matvec_spec(300, 170),
                                        mode="paper"))
    assert (f["in0_prow"], f["in0_pcol"], f["in1_pcol"]) == (300, 176, 176)
    with pytest.raises(ValueError, match="may use 232448"):
        tiled.layout("gemm_mxu", tad.plan(tad.matmul_spec(1024, 1024, 1024),
                                          budget=1 << 20))
    # an output tile past 8 warps x 4 fragments is covered in passes
    f = tiled.layout("gemm_mxu", _plan_with_tiles(
        tad.matmul_spec(1024, 1024, 32), (256, 256, 32)))
    assert (f["fpw"], f["threads"], f["npass"]) == (4, 256, 4)
    with pytest.raises(ValueError, match="does not fit"):
        tiled.layout("matvec", tad.plan(spec))
    with pytest.raises(ValueError, match="does not fit the axis maps"):
        tiled.layout("matvec", tad.plan(tpb.matvec_t_spec(512, 384)))
    # an unmodified plan runs on the kernel's own grid, in one k-step
    f = tiled.layout("gemm_vpu", tad.plan(spec, mode="unmodified"))
    assert (f["staged"], f["smem"], f["ntile2"], f["blocks"]) == (0, 0, 1, 20)
    f = tiled.layout("matvec", tad.plan(tad.matvec_spec(2048, 2048),
                                        mode="unmodified"))
    assert (f["staged"], f["blocks"], f["ntile1"]) == (0, 256, 1)


def test_walker_runs_a_custom_body_and_counts_no_launch():
    """tiled_call on CPU tensors is the grid walker: a body that adds its
    block's reduction-step product gives A @ B at a ragged plan."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((40, 70)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((70, 50)).astype(np.float32))
    seen = []

    def body(a, b, c, *, axis_info):
        k, nk = axis_info[2]
        seen.append((tuple(a.shape), tuple(b.shape), k, nk))
        c.copy_(a @ b if k == 0 else c + a @ b)

    spec = tad.matmul_spec(40, 50, 70)
    p = tgemm._plan_with_tiles(spec, (16, 32, 32))
    n0 = tiled.launch.launches
    call, p2 = tad.tiled_call(tad.Body("gemm_mxu", body), spec, plan_=p)
    assert p2 is p
    np.testing.assert_allclose(call(A, B).numpy(), (A @ B).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert len(seen) == 3 * 2 * 3 and seen[-1] == ((8, 6), (6, 18), 2, 3)
    assert tiled.launch.launches == n0


def test_suite_modules_leave_jax_and_repro_out():
    code = ("import sys\n"
            "import repro_torch.kernels.ops, repro_torch.core.autodma\n"
            "import repro_torch.launch.kernel_suite\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ISOLATED')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=SRC,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr
