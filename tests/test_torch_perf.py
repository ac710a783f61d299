"""core/perf.py against the JAX package's: the roofline given the
reference's constants, the ring model on the collectives of
``test_collective_parser`` (as records of what was issued, in place of
HLO text), the hero_perf counters' errors and events, the trace count's
storage following; the kernel
wrappers' FLOP reports against FlopCounterMode's count of their plain
versions; and the collectives parallel/sharding.py records on an
abstract mesh, through core/offload.py's ``TargetRegion.trace``."""
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.utils.flop_counter import FlopCounterMode

from repro.core import perf as jperf
from repro_torch.core import offload, perf
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.parallel import sharding

REF_CHIP = perf.Chip("the reference's constants", jperf.PEAK_FLOPS,
                     jperf.HBM_BW, jperf.ICI_BW)
HLO = """
  %all-gather.1 = f32[896,8]{1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={0}
  %all-reduce.2 = bf16[16,1024]{1,0} all-reduce(%y), replica_groups=[32,8]<=[256], to_apply=%add
  %all-gather-done.3 = f32[8,8]{1,0} all-gather-done(%ags)
  %collective-permute.4 = f32[4,4]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
"""
# the same collectives as issued (the -done half of an async pair issues
# nothing of its own)
RECORDS = [perf.Collective("all-gather", 896 * 8 * 4, 16),
           perf.Collective("all-reduce", 16 * 1024 * 2, 8),
           perf.Collective("collective-permute", 4 * 4 * 4, 2)]


@settings(max_examples=40, deadline=None)
@given(st.floats(0, 1e20), st.floats(0, 1e15), st.floats(0, 1e13),
       st.integers(1, 512), st.floats(0, 1e20))
def test_roofline_equals_the_reference_given_its_constants(f, b, c, chips,
                                                           mf):
    got = perf.Roofline(f, b, c, chips, mf, chip=REF_CHIP).as_dict()
    want = jperf.Roofline(f, b, c, chips, mf).as_dict()
    assert got == want


def test_roofline_on_the_h100_and_an_unknown_collective_term():
    rl = perf.Roofline(flops=989e12 * 256, hbm_bytes=0, coll_bytes=0,
                       chips=256, model_flops=989e12 * 256 * 0.5)
    assert abs(rl.compute_s - 1.0) < 1e-12 and rl.dominant == "compute"
    assert abs(rl.roofline_fraction - 0.5) < 1e-12
    assert rl.chip is perf.H100 and perf.H100.hbm_bw == 3.35e12
    none = perf.Roofline(flops=1.0, hbm_bytes=3.35e12, coll_bytes=None,
                         chips=1)
    d = none.as_dict()
    assert d["collective_s"] is None and d["dominant"] == "memory"
    assert d["bound_s"] == 1.0
    assert set(d) == set(jperf.Roofline(1, 1, 1, 1).as_dict())


def test_collective_bytes_reproduce_the_reference_parser():
    want = jperf.collective_bytes(HLO)
    got = perf.collective_bytes(RECORDS)
    assert got == want
    assert got["counts"]["all-gather"] == 1
    assert abs(got["all-gather"] - 896 * 8 * 4 * 15 / 16) < 1
    rs = perf.collective_bytes([perf.Collective("reduce-scatter", 100, 4),
                                perf.Collective("all-to-all", 64, 4)])
    assert rs["reduce-scatter"] == 300 and rs["all-to-all"] == 48
    with pytest.raises(ValueError, match="unknown collective"):
        perf.collective_bytes([perf.Collective("broadcast", 1, 2)])


def test_perf_session_keeps_the_reference_s_errors_and_events():
    for mod in (perf, jperf):
        s = mod.PerfSession(max_counters=2)
        with pytest.raises(ValueError, match="unsupported event"):
            s.hero_perf_alloc("CYCLES")
        w = s.hero_perf_alloc("WALL_NS")
        s.hero_perf_alloc("DMA_BURSTS")
        with pytest.raises(RuntimeError, match="exhausted"):
            s.hero_perf_alloc("HLO_FLOPS")
        s.hero_perf_continue_all()
        s.hero_perf_pause_all()
        assert s.hero_perf_read(w) > 0
        s.attach_plan(type("Plan", (), {"dma_bursts": 7})())
        assert s.hero_perf_read(1) == 7
    assert perf.EVENTS == jperf.EVENTS
    assert perf.COLLECTIVE_OPS == jperf.COLLECTIVE_OPS
    s = perf.PerfSession()
    ids = [s.hero_perf_alloc(e) for e in ("HLO_FLOPS", "HLO_BYTES",
                                          "COLL_BYTES")]
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with perf.TraceCount() as count:
        a @ b
    s.attach_trace(count, RECORDS)
    assert s.hero_perf_read(ids[0]) == 2 * 8 * 16 * 4
    assert s.hero_perf_read(ids[1]) == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert s.hero_perf_read(ids[2]) == jperf.collective_bytes(HLO)["total"]
    assert perf.timeit(lambda x: x + 1, a, iters=3) > 0


def test_trace_count_follows_the_storages_a_pass_creates():
    a = torch.empty(1000, device="meta")          # 4000 B, not the pass's
    with perf.TraceCount() as c:
        b = a * 2                                 # new: live 4000
        d = b + 1                                 # new: live 8000, the peak
        del b                                     # freed: live 4000
        e = d[:10]                                # a view: nothing new
        d.add_(1)                                 # in place: nothing new
        f = d * 3                                 # new: live 8000
        del d, e                                  # freed at the view's end
    assert (c.peak_bytes, c.end_bytes) == (8000, 4000)
    assert c.bytes == 4 * 8000 and f.shape == (1000,)


def test_kernel_flop_reports_equal_their_plain_versions_count():
    g = torch.Generator().manual_seed(0)
    B, H, K, S, hd = 2, 4, 2, 1536, 32
    q = torch.randn(B, H, hd, generator=g)
    k, v = (torch.randn(B, K, S, hd, generator=g) for _ in range(2))
    lens = torch.full((B,), 700, dtype=torch.int32)
    with FlopCounterMode(display=False) as c:
        da.flash_decode(q, k, v, lens)
    assert c.get_total_flops() == da.plain_flops(
        B, H, S, hd, da.decode_block_k(S, 512))
    for causal, L, Lk in ((True, 300, 300), (False, 96, 500)):
        q = torch.randn(1, 2, L, hd, generator=g)
        kk = torch.randn(1, 2, Lk, hd, generator=g)
        with FlopCounterMode(display=False) as c:
            fa.flash_attention(q, kk, kk, causal)
        bq, bk = fa._blocks(q, kk, None, None)
        assert c.get_total_flops() == fa.plain_flops(2, L, Lk, hd, causal,
                                                     bq, bk)
    # a launch's report reaches every open TraceCount, and no other
    with perf.TraceCount() as outer:
        with perf.TraceCount() as inner:
            perf.add_kernel_flops("k", 5.0)
        perf.add_kernel_flops("k", 2.0)
    perf.add_kernel_flops("k", 100.0)
    assert inner.flops == 5.0 and outer.flops == 7.0


def test_collectives_recorded_on_an_abstract_mesh_and_trace_cache():
    mesh = sharding.Mesh.abstract((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match="abstract"):
        mesh.line("data")
    x = torch.empty(6, 8, dtype=torch.bfloat16, device="meta")

    def step(x):
        line = sharding.current_mesh().line("data")
        y = sharding.gather_shards(x, line, 0)           # all-gather
        z = sharding.reduce_from(y.float().sum(0), line)  # all-reduce
        w = sharding.ring_shift(x, sharding.current_mesh().line("model"))
        return y, z, w, sharding.all_to_all(x, line)

    region = offload.target(name="probe")(step)
    with sharding.use_mesh(mesh):
        tr = region.trace(x)
        again = region.trace(torch.empty(6, 8, dtype=torch.bfloat16,
                                         device="meta"))
    assert again is tr and region.stats.n_traces == 1
    y, z, w, a = tr.outputs
    assert y.shape == (24, 8) and z.shape == (8,) and w.shape == (6, 8)
    assert a.shape == (6, 8)
    assert [(r.kind, r.nbytes, r.group) for r in tr.collectives] == [
        ("all-gather", 4 * 6 * 8 * 2, 4), ("all-reduce", 8 * 4, 4),
        ("all-gather", 2 * 6 * 8 * 2, 2), ("all-to-all", 6 * 8 * 2, 4)]
    with pytest.raises(ValueError, match="record_collectives"):
        sharding._sum(x, sharding.Line(("data",), 4, 0, (), None))
