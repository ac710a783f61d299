"""The host-DRAM swap tier in the port, held against the JAX reference.

  * ``core/dma.py``'s host half: handles, stamps, round trips (CPU here;
    the pinned, copy-stream path in a ``cuda``-marked test);
  * ``TieredCachePool``: a swap round trip restores every leaf bit for bit
    (compute-dtype pages and int8 pages with their scale rows) and leaves
    the same host bytes, pool pages and counters as the reference's pool; a
    mid-prefill swap moves only the valid prefix; a cold sequence cannot
    re-admit; a refused host budget is a guarantee;
  * the chunked engine on the tiered stacks against the JAX chunked engine
    on seeded oversubscribed mixes (compute and int8 pages, with and without
    the prefix layer, the overlapped loop on and off): equal greedy streams
    and counters, accounting closed at drain, one mix that preempts
    mid-prefill and one that preempts while a resume's copies are in flight.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import heromem as jheromem
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.tiering import TieredCachePool as JTieredCachePool
from repro_torch import configs as tconfigs
from repro_torch.core import dma
from repro_torch.core import heromem as theromem
from repro_torch.core import vmm as tvmm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine
from repro_torch.serve.tiering import TieredCachePool

from test_torch_engine import _weights

TIER_COUNTERS = ("preemptions", "preempted_mid_prefill", "swap_out_count",
                 "swap_in_count", "swap_out_bytes", "swap_in_bytes",
                 "admission_refusals", "evictions_reprefill", "decode_steps",
                 "prefill_chunk_tokens", "prefix_hits", "prefix_full_hits",
                 "prefix_shared_tokens", "cow_forks")


# --------------------------------------------------------------------------
# core/dma.py
# --------------------------------------------------------------------------
def test_dma_handles_on_the_cpu():
    ticks = itertools.count(100)
    clock = lambda: float(next(ticks))                       # noqa: E731
    src = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    h = dma.hero_memcpy_dev2host_async(src, clock=clock)
    assert h.nbytes == 24 * 4 and h.t_start == 100.0 and h.t_done == 0.0
    out = dma.hero_memcpy_wait(h)
    assert h.t_done == 101.0
    assert dma.hero_memcpy_wait(h) is out and h.t_done == 101.0  # idempotent
    assert torch.equal(out, src) and out.data_ptr() != src.data_ptr()
    back = dma.hero_memcpy_host2dev_async("cpu", out, clock=clock)
    assert back.to_device and back.t_start == 102.0
    (got,) = dma.hero_memcpy_wait_all([back])
    assert torch.equal(got, src) and got.data_ptr() != out.data_ptr()
    assert back.start is None and back.done is None         # no card here
    assert back._id > h._id
    dst = torch.empty_like(src)
    assert dma.hero_memcpy_dev2host(dst, src * 2) is dst
    assert torch.equal(dst, src * 2)
    i8 = torch.randint(-128, 128, (5, 7), dtype=torch.int8)
    assert torch.equal(dma.hero_memcpy_host2dev("cpu", i8), i8)
    assert dma.hero_memcpy_dev2host_async(i8).nbytes == 35


@pytest.mark.cuda
def test_dma_round_trip_on_the_card():
    """On the card: dev→host lands in pinned memory through the copy
    stream; host→dev refuses pageable memory; a round trip is exact and its
    copy-stream window is timed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_tiering.py)")
    src = torch.randn(64, 1024, device="cuda").to(torch.bfloat16)
    out = dma.hero_memcpy_dev2host_async(src)
    host = out.wait()
    assert host.is_pinned() and host.device.type == "cpu"
    with pytest.raises(ValueError, match="pinned"):
        dma.hero_memcpy_host2dev_async("cuda", host.clone())
    back = dma.hero_memcpy_host2dev_async("cuda", host)
    got = back.wait()
    torch.cuda.synchronize()
    assert torch.equal(got, src)
    assert dma.device_window_ms([out]) > 0.0
    assert dma.device_window_ms([back]) > 0.0


# --------------------------------------------------------------------------
# the tiered pool, against the reference's
# --------------------------------------------------------------------------
def _pools(kv_dtype="compute", n_pages=8, page_tokens=4, max_batch=3,
           max_seq=16, host_budget=1 << 16):
    """The port's and the reference's tiered pools, default (bf16) smoke
    config."""
    kw = dict(max_batch=max_batch, max_seq=max_seq, n_pages=n_pages,
              page_tokens=page_tokens, host_budget_bytes=host_budget,
              kv_dtype=kv_dtype)
    return (TieredCachePool(tconfigs.get_smoke_config("qwen2-0.5b"), **kw),
            JTieredCachePool(jconfigs.get_smoke_config("qwen2-0.5b"), **kw))


def _rows(tpool, n, seed):
    """Seeded contents for n pages of every leaf: (group, pos, leaf) ->
    numpy rows shaped [count, n, ...] (int8 payload, positive scales)."""
    rng = np.random.default_rng(seed)
    out = {}
    for gi, per_pos in enumerate(tpool.pages):
        for pi, kv in enumerate(per_pos):
            for name in sorted(kv):
                arr = kv[name]
                shape = (arr.shape[0], n) + tuple(arr.shape[2:])
                if arr.dtype == torch.int8:
                    out[gi, pi, name] = rng.integers(
                        -127, 128, shape).astype(np.int8)
                elif name.endswith("_scale"):
                    out[gi, pi, name] = rng.uniform(
                        0.01, 1.0, shape).astype(np.float32)
                else:
                    out[gi, pi, name] = rng.standard_normal(
                        shape).astype(np.float32)
    return out


def _write(tpool, jpool, ids, rows):
    """Land the same rows on pages ``ids`` of both pools."""
    tids = torch.tensor(ids)
    for (gi, pi, name), r in rows.items():
        arr = tpool.pages[gi][pi][name]
        arr[:, tids] = torch.from_numpy(r).to(arr.dtype)
    jpool.pages = [tuple({name: arr.at[:, jnp.asarray(ids)].set(
        jnp.asarray(rows[gi, pi, name]).astype(arr.dtype))
        for name, arr in kv.items()} for pi, kv in enumerate(per_pos))
        for gi, per_pos in enumerate(jpool.pages)]


def _read(pool, ids, port):
    """Pages ``ids`` of every leaf as numpy (bf16 widened to f32)."""
    out = {}
    for gi, per_pos in enumerate(pool.pages):
        for pi, kv in enumerate(per_pos):
            for name, arr in kv.items():
                if port:
                    rows = arr[:, torch.tensor(ids)]
                    if rows.dtype == torch.bfloat16:
                        rows = rows.float()
                    out[gi, pi, name] = rows.numpy()
                else:
                    rows = arr[:, jnp.asarray(ids)]
                    if rows.dtype == jnp.bfloat16:
                        rows = rows.astype(jnp.float32)
                    out[gi, pi, name] = np.asarray(rows)
    return out


def _host(pool, sid, port):
    rec = pool._cold[sid]
    return {(gi, pi, name): (v.float() if v.dtype == torch.bfloat16
                             else v).numpy() if port
            else np.asarray(jnp.asarray(v).astype(jnp.float32)
                            if v.dtype == jnp.bfloat16 else v)
            for gi, row in enumerate(rec.host)
            for pi, ent in enumerate(row) for name, v in ent.items()}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def _tier_state(pool):
    return (sorted(pool.cold_seqs()), pool.host_used_bytes(),
            pool.host_free_bytes(), pool.hero.levels[3].in_use(),
            pool.swap_out_count, pool.swap_in_count, pool.swap_out_bytes,
            pool.swap_in_bytes, list(np.asarray(pool.seq_ids)),
            list(np.asarray(pool.lengths)),
            sorted((s, list(p)) for s, p in pool.alloc._seq_pages.items()),
            pool.alloc.free_pages)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_swap_round_trip_is_bit_exact_and_matches_the_reference(kv_dtype):
    """swap_out → swap_in restores every leaf (an int8 pool's scale rows
    too) bit for bit, on other physical pages, with the reference's host
    bytes, counters, L3 arena and page lists after every step."""
    tpool, jpool = _pools(kv_dtype)
    L = 10                                                  # 3 pages
    for pool in (tpool, jpool):
        pool.admit_prefill(seq_id=0, prompt_len=L)
        pool.lengths[0] = L
    ids = list(tpool.alloc._seq_pages[0])
    rows = _rows(tpool, len(ids), seed=2)
    _write(tpool, jpool, ids, rows)
    before = _read(tpool, ids, port=True)
    _equal(before, _read(jpool, ids, port=False))
    for pool in (tpool, jpool):
        assert pool.can_swap_out(0)
        assert pool.swap_out(0) == 0
    assert _tier_state(tpool) == _tier_state(jpool)
    assert tpool.is_cold(0) and tpool.alloc.free_pages == tpool.alloc.n_pages
    _equal(_host(tpool, 0, True), _host(jpool, 0, False))
    _equal(_host(tpool, 0, True), before)
    assert tpool.swap_out_bytes == 3 * tpool.page_nbytes()
    assert tpool.hero.levels[3].in_use() == \
        theromem.fragment_size(3 * tpool.page_nbytes())
    # another sequence takes the freed pages: the resume lands elsewhere
    for pool in (tpool, jpool):
        pool.admit_prefill(seq_id=1, prompt_len=4)
        slot = pool.swap_in(0)
    new_ids = list(tpool.alloc._seq_pages[0])
    assert new_ids != ids and int(tpool.lengths[slot]) == L
    assert _tier_state(tpool) == _tier_state(jpool)
    _equal(_read(tpool, new_ids, port=True), before)
    _equal(_read(jpool, new_ids, port=False), before)
    assert tpool.swap_in_bytes == tpool.swap_out_bytes
    for pool in (tpool, jpool):
        pool.release(slot)
        pool.release(0 if slot else 1)
    assert tpool.hero.levels[3].in_use() == 0
    assert tpool.alloc.free_pages == tpool.alloc.n_pages
    assert tpool.host_free_bytes() == jpool.host_free_bytes()
    tpool.alloc.audit()


def test_mid_prefill_swap_moves_only_the_valid_prefix():
    """A half-prefilled sequence owns every prompt page but has written
    only up to its chunk offset: only the pages that cover it travel and
    are budgeted, and the resume continues at that offset."""
    tpool, jpool = _pools(n_pages=8, page_tokens=4, max_batch=2, max_seq=32)
    L, written = 12, 5                        # 3 prompt pages, 2 written
    for pool in (tpool, jpool):
        pool.admit_prefill(seq_id=0, prompt_len=L)
        pool.lengths[0] = written
    ids = list(tpool.alloc._seq_pages[0])
    assert len(ids) == 3
    _write(tpool, jpool, ids, _rows(tpool, 3, seed=3))
    before = _read(tpool, ids[:2], port=True)
    for pool in (tpool, jpool):
        pool.swap_out(0)
    assert _tier_state(tpool) == _tier_state(jpool)
    rec = tpool._cold[0]
    assert rec.n_valid == 2 and rec.n_pages == 3 and rec.length == written
    assert tpool.swap_out_bytes == 2 * tpool.page_nbytes()
    assert tpool.hero.levels[3].in_use() == \
        theromem.fragment_size(2 * tpool.page_nbytes())
    slots = [pool.swap_in(0) for pool in (tpool, jpool)]
    assert int(tpool.lengths[slots[0]]) == written
    assert len(tpool.alloc._seq_pages[0]) == 3     # the whole list re-mapped
    assert _tier_state(tpool) == _tier_state(jpool)
    restored = list(tpool.alloc._seq_pages[0])[:2]
    _equal(_read(tpool, restored, port=True), before)
    for pool, slot in zip((tpool, jpool), slots):
        pool.release(slot)
    assert tpool.hero.levels[3].in_use() == 0
    assert tpool.alloc.free_pages == tpool.alloc.n_pages


def test_cold_sequence_cannot_readmit():
    tpool, _ = _pools()
    slot = tpool.admit_prefill(seq_id=3, prompt_len=4)
    tpool.lengths[slot] = 4
    tpool.swap_out(slot)
    with pytest.raises(ValueError, match="cold tier"):
        tpool.admit_prefill(seq_id=3, prompt_len=4)
    assert not tpool.can_resume(99)
    tpool.drop_cold(3)
    assert tpool.hero.levels[3].in_use() == 0 and not tpool.cold_seqs()
    with pytest.raises(tvmm.StaleSequenceError):
        tpool.drop_cold(3)
    with pytest.raises(ValueError, match="free slot"):
        tpool.swap_out(slot)
    with pytest.raises(MemoryError):
        tpool.swap_in_start(3)


def test_host_budget_refusal_is_guaranteed():
    """can_swap_out False means swap_out raises and leaves the resident
    untouched; the reference's pool refuses at the same point."""
    tpool, jpool = _pools(n_pages=16, page_tokens=8, max_batch=2,
                          max_seq=64, host_budget=None)
    nbytes = 2 * tpool.page_nbytes()
    budget = theromem.fragment_size(nbytes)     # one 2-page sequence
    tpool, jpool = _pools(n_pages=16, page_tokens=8, max_batch=2,
                          max_seq=64, host_budget=budget)
    for pool in (tpool, jpool):
        a = pool.admit_prefill(seq_id=0, prompt_len=16)
        b = pool.admit_prefill(seq_id=1, prompt_len=16)
        pool.lengths[a] = pool.lengths[b] = 16
        assert pool.can_swap_out(a)
        pool.swap_out(a)
        assert not pool.can_swap_out(b)
        with pytest.raises(MemoryError):
            pool.swap_out(b)
        assert int(pool.seq_ids[b]) == 1
    assert jheromem.fragment_size(nbytes) == budget
    assert _tier_state(tpool) == _tier_state(jpool)


def test_default_host_budget_and_metrics_match_the_reference():
    tpool, jpool = _pools("int8", host_budget=None)
    assert tpool.page_nbytes() == jpool.hot.page_nbytes()
    assert tpool.host_free_bytes() == jpool.host_free_bytes()
    from repro.serve.metrics import MetricsBus as JBus
    from repro_torch.serve.metrics import MetricsBus as TBus
    tbus, jbus = TBus(), JBus()
    tpool.publish_metrics(tbus)
    jpool.publish_metrics(jbus)
    assert tbus.snapshot() == jbus.snapshot()


# --------------------------------------------------------------------------
# the chunked engine on the tiered stacks
# --------------------------------------------------------------------------
def _mix(name, vocab):
    """name -> (schedule [(arrival, prompt, max_new)], n_slots, token_budget,
    n_pages), each oversubscribing a hot tier of 8-token pages."""
    if name == "shared":
        # the reference's prefix + tiering mix: swap-outs of sequences that
        # hold adopted prefix pages
        rng = np.random.default_rng(17)
        shared = rng.integers(0, vocab, 12)
        return [(2 * i, np.concatenate([shared, rng.integers(
            0, vocab, 3 + i)]).astype(np.int32), 3) for i in range(4)], 2, 6, 6
    rng = np.random.default_rng({"midprefill": 1, "prefetch": 8}[name])
    head = rng.integers(0, vocab, 10)
    if name == "midprefill":
        # long prompts through a small budget: residents are preempted
        # between chunks
        lens = rng.integers(14, 31, 4)
        arrivals = sorted(rng.integers(0, 4, 4))
        news = rng.integers(2, 5, 4)
        return [(int(a), np.concatenate([head, rng.integers(
            0, vocab, int(n) - 10)]).astype(np.int32), int(m))
            for a, n, m in zip(arrivals, lens, news)], 2, 6, 8
    # short random prompts over three slots: with overlap on, a shadow-phase
    # admission preempts while a resume's copies are in flight
    sched = []
    for _ in range(6):
        body = rng.integers(0, vocab, int(rng.integers(1, 16)))
        prompt = np.concatenate([head[:int(rng.integers(0, 11))], body])
        sched.append((int(rng.integers(0, 8)), prompt.astype(np.int32),
                      int(rng.integers(1, 5))))
    return sched, 3, 7, 8


MIX_NAMES = ("midprefill", "prefetch", "shared")


def _drive(eng, request_cls, schedule, max_iters=4000):
    pending = sorted(enumerate(schedule), key=lambda t: (t[1][0], t[0]))
    done, it = [], 0
    while True:
        while pending and pending[0][1][0] <= it:
            sid, (_, prompt, max_new) = pending.pop(0)
            assert eng.submit(request_cls(seq_id=sid, prompt=prompt.copy(),
                                          max_new=max_new))
        if not pending and eng.idle:
            return {r.seq_id: list(r.tokens_out) for r in done}
        done.extend(eng.step())
        it += 1
        assert it <= max_iters, "the scheduler did not drain the workload"


def _spy_inflight_preemptions(eng):
    """Count swap-outs made while a resume's copies are still in flight."""
    box = [0]
    swap_out = eng.pool.swap_out

    def spy(slot):
        box[0] += bool(eng.scheduler._pending_swapins)
        return swap_out(slot)
    eng.pool.swap_out = spy
    return box


def _budget(cfg, n_req, pt):
    from repro.serve.kvcache import token_bytes
    return 16 * 2 * n_req * token_bytes(cfg) * pt


@functools.lru_cache(maxsize=None)
def _jax_tiered_run(name, kv_dtype, prefix, overlap):
    cfg, tree = _weights()
    sched, slots, budget, pages = _mix(name, cfg.vocab)
    eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  config=JEngineConfig(
                      n_slots=slots, max_seq=64, chunked=True,
                      token_budget=budget, overlap=overlap,
                      cache=JCacheConfig(
                          paged=True, tiered=True, page_tokens=8,
                          n_pages=pages, prefix=prefix,
                          prefix_pages=pages // 2 if prefix else None,
                          host_budget_bytes=_budget(cfg, len(sched), 8),
                          kv_dtype=kv_dtype)))
    inflight = _spy_inflight_preemptions(eng)
    streams = _drive(eng, JRequest, sched)
    return streams, {k: eng.stats[k] for k in TIER_COUNTERS}, inflight[0]


def _port_tiered_engine(name, kv_dtype, prefix, overlap, **extra):
    cfg, tree = _weights()
    sched, slots, budget, pages = _mix(name, cfg.vocab)
    tcfg = tconfigs.get_smoke_config("qwen2-0.5b",
                                     compute_dtype=torch.float32)
    return tengine.Engine(
        tcfg, params_from_numpy(tree, tcfg), device="cpu",
        config=tengine.EngineConfig(
            n_slots=slots, max_seq=64, chunked=True, token_budget=budget,
            overlap=overlap, **extra,
            cache=tcache.CacheConfig(
                tiered=True, page_tokens=8, n_pages=pages, prefix=prefix,
                prefix_pages=pages // 2 if prefix else None,
                host_budget_bytes=_budget(cfg, len(sched), 8),
                kv_dtype=kv_dtype))), sched


def _check_tier_closed(eng, sched):
    """Accounting closes at drain on a tiered stack."""
    s = eng.stats
    assert s["swap_out_count"] == s["swap_in_count"] == s["preemptions"]
    assert s["swap_out_bytes"] == s["swap_in_bytes"]
    summ = eng.stats_summary()
    assert summ["max_iter_tokens"] <= summ["token_budget"]
    assert summ["peak_in_system"] <= len(sched)
    pool = eng.pool
    assert eng.idle and not pool.cold_seqs() and pool.host_used_bytes() == 0
    assert pool.hero.levels[3].in_use() == 0
    assert pool.alloc._seq_pages == {} and pool._reserved == {}
    assert not eng.scheduler._pending_swapins
    a = pool.alloc
    cached = [] if eng.prefix is None else eng.prefix.cached_pages()
    assert all(a.refcount(p) == 1 for p in cached)
    assert a.free_pages == a.n_pages - len(cached)
    a.audit()
    if eng.prefix is not None:
        eng.prefix.clear()
        assert a.free_pages == a.n_pages


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("prefix", [False, True], ids=["tiered", "prefix"])
@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
@pytest.mark.parametrize("mix", MIX_NAMES)
def test_tiered_engine_matches_jax_engine(mix, kv_dtype, prefix, overlap):
    streams, counters, jax_inflight = _jax_tiered_run(mix, kv_dtype, prefix,
                                                      overlap)
    eng, sched = _port_tiered_engine(mix, kv_dtype, prefix, overlap)
    inflight = _spy_inflight_preemptions(eng)
    assert _drive(eng, tengine.Request, sched) == streams
    assert {k: eng.stats[k] for k in TIER_COUNTERS} == counters
    assert inflight[0] == jax_inflight
    assert len(streams) == len(sched)
    assert counters["preemptions"] > 0
    if mix == "midprefill":
        assert counters["preempted_mid_prefill"] > 0
    if mix == "prefetch" and overlap:
        assert inflight[0] > 0, "no preemption met an in-flight resume"
    if prefix and mix == "shared":
        assert counters["prefix_hits"] > 0
    _check_tier_closed(eng, sched)


def test_tiered_engine_traces_swaps_on_an_injected_clock():
    """The swap copies' stamps come from the engine's injected clock; each
    swap phase leaves one ``dma`` window and ``swap_wait`` spans; the tier
    publishes its gauges and totals; streams equal the untraced run's."""
    ticks = itertools.count()
    clock = lambda: float(next(ticks)) * 1e-3                # noqa: E731
    eng, sched = _port_tiered_engine("midprefill", "compute", False, True,
                                     trace=True, clock=clock)
    plain, _ = _port_tiered_engine("midprefill", "compute", False, True)
    assert _drive(eng, tengine.Request, sched) == \
        _drive(plain, tengine.Request, sched)
    last = eng.pool.last_transfers
    assert last and all(h.t_done >= h.t_start for h in last)
    assert all(h.t_start * 1e3 == round(h.t_start * 1e3) for h in last)
    events = eng.tracer.chrome_trace()["traceEvents"]
    dma_names = [e["name"] for e in events
                 if e.get("cat") == "dma" and e["ph"] == "b"]
    n = eng.stats["swap_out_count"]
    assert dma_names.count("swap_out_dma") == n
    assert dma_names.count("swap_in_dma") == eng.stats["swap_in_count"]
    assert sum(e["name"] == "swap_wait" for e in events
               if e["ph"] == "X") == 2 * n
    assert "stall_pct_dma" in eng.trace_summary()
    snap = eng.metrics_snapshot()
    for k in ("swap_out_count", "swap_in_count", "swap_out_bytes",
              "swap_in_bytes"):
        assert snap["counters"][k] == eng.stats[k]
    assert snap["gauges"]["cold_seqs"] == 0
    assert snap["gauges"]["host_free_bytes"] == eng.pool.host_free_bytes()
