"""Shared-prefix reuse in the port, held against the JAX reference.

Three layers of the same property, all on the CPU at the smoke config:

  * ``PrefixCache`` (a copy of the reference's radix index) gives the
    reference's results on the same insert / match / evict sequences:
    match lengths, pages, first tokens, evicted pages, fingerprints;
  * the eight cache stacks the port builds ({paged, int8} × {±tiered} ×
    {±prefix}) satisfy ``CacheManager`` by static lookup, and seeded
    random admit / reserve / ensure / COW / insert / release sequences (on
    a tiered stack also page writes, swap-out, swap-in start and finish)
    leave the allocator, the cold tier, the L3 arena and the swap counters
    exactly as the reference's stack leaves them, and the resumed pages'
    bytes equal the reference's after every swap-in; they never leak, keep
    ``audit()`` clean and close the refcounts (one reference per cached
    page after every sequence releases; ``clear()`` restores the pool);
  * the port's engine on a prefix stack (and on int8 + prefix) gives the
    JAX engine's greedy streams and counters on shared-prefix schedules,
    with the overlapped loop on and off; and with ``greedy=False`` (no
    prompt indexed, a cached first token not trusted: a full-prompt match
    trimmed by one position) on schedules with exact re-arrivals.
"""
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vmm as jvmm
from repro.serve import prefix_cache as jpc
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.cache import build_cache_manager as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core import vmm as tvmm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine
from repro_torch.serve import prefix_cache as tpc

from test_torch_engine import COUNTERS, _weights


# --------------------------------------------------------------------------
# the radix index
# --------------------------------------------------------------------------
class _Donor:
    """What ``PrefixCache.insert`` needs of a pool: the allocator and the
    reservation hook (which refuses every ``refuse``-th tail share)."""

    def __init__(self, alloc, refuse):
        self.alloc, self.refuse, self.calls = alloc, refuse, 0

    def reserve_extra(self, seq_id, n=1):
        self.calls += 1
        return self.calls % self.refuse != 0


def _index_ops(seed, n_ops=120, pt=4):
    """Seeded op list over a few shared prefixes: insert, match, evict."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, 50, int(rng.integers(1, 3 * pt + 2)))
             for _ in range(3)]
    ops, inserted = [], []
    for _ in range(n_ops):
        kind = ("insert", "match", "evict", "evict_free")[
            int(rng.choice(4, p=[0.4, 0.4, 0.1, 0.1]))]
        b = bases[int(rng.integers(0, 3))]
        prompt = np.concatenate(
            [b[:int(rng.integers(1, len(b) + 1))],
             rng.integers(0, 50, int(rng.integers(0, pt + 2)))])
        if kind == "insert":
            inserted.append(prompt)
        elif kind == "match" and inserted and rng.random() < 0.5:
            prompt = inserted[int(rng.integers(0, len(inserted)))]
        ops.append((kind, prompt.astype(np.int32), int(rng.integers(0, 99)),
                    int(rng.integers(1, 4))))
    return ops


def _replay_index(pc_mod, vmm_mod, ops, pt=4, n_pages=64, cap=12):
    alloc = vmm_mod.PagedAllocator(n_pages, pt, 8)
    cache = pc_mod.PrefixCache(alloc, pt, max_pages=cap)
    donor = _Donor(alloc, refuse=5)
    trace, sid = [], 0
    for kind, prompt, tok, n in ops:
        if kind == "insert":
            alloc.alloc_seq(sid, len(prompt))
            trace.append(("insert", cache.insert(donor, sid, prompt, tok)))
            alloc.free_seq(sid)
            sid += 1
        elif kind == "match":
            m = cache.match(prompt)
            trace.append(("match", m.length, list(m.pages), m.first_token))
        else:
            got = cache.evict_lru(n, require_free=kind == "evict_free")
            trace.append((kind, got))
        alloc.audit()
        trace.append(("state", sorted(cache.cached_pages()),
                      cache.held_pages, dict(cache.stats()),
                      alloc.free_pages))
    fps = cache.fingerprints()
    cands = pc_mod.prompt_fingerprints(ops[0][1], pt)
    trace.append(("fingerprints", sorted(fps.items()), cands,
                  pc_mod.longest_fingerprint_match(cands, fps)))
    trace.append(("clear", cache.clear(), cache.held_pages,
                  alloc.free_pages))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_equals_the_reference(seed):
    ops = _index_ops(seed)
    got = _replay_index(tpc, tvmm, ops)
    assert got == _replay_index(jpc, jvmm, ops)
    assert any(t[0] == "match" and t[3] is not None for t in got)
    assert any(t[0].startswith("evict") and t[1] for t in got)


# --------------------------------------------------------------------------
# the cache stacks
# --------------------------------------------------------------------------
STACKS = {   # name -> CacheConfig fields shared by both packages
    "paged": dict(), "prefix": dict(prefix=True, prefix_pages=4),
    "int8": dict(kv_dtype="int8"),
    "int8_prefix": dict(prefix=True, prefix_pages=4, kv_dtype="int8"),
    # a host budget that refuses some swap-outs (2 KiB f32 pages, 544 B
    # int8 pages; o1heap rounds each record up to a power of two)
    "tiered": dict(tiered=True, host_budget_bytes=16384),
    "tiered_prefix": dict(tiered=True, host_budget_bytes=16384,
                          prefix=True, prefix_pages=4),
    "int8_tiered": dict(tiered=True, host_budget_bytes=4096,
                        kv_dtype="int8"),
    "int8_tiered_prefix": dict(tiered=True, prefix=True, prefix_pages=4,
                               kv_dtype="int8")}


def _stacks(name, n_slots=3, max_seq=16):
    kw = dict(page_tokens=4, n_pages=10, **STACKS[name])
    tcfg = tconfigs.get_smoke_config("qwen2-0.5b",
                                     compute_dtype=torch.float32)
    jcfg = _weights()[0]
    return (tcache.build_cache_manager(tcfg, tcache.CacheConfig(**kw),
                                       n_slots, max_seq),
            jbuild(jcfg, JCacheConfig(paged=True, **kw), n_slots, max_seq))


def _state(pool):
    a = pool.alloc
    state = (sorted((s, list(p)) for s, p in a._seq_pages.items()),
             sorted(a._refcount.items()), sorted(a._free),
             list(np.asarray(pool.seq_ids)), list(np.asarray(pool.lengths)),
             None if pool.prefix is None
             else sorted(pool.prefix.cached_pages()))
    if not hasattr(pool, "swap_out"):
        return state
    return state + (sorted(pool.cold_seqs()), pool.host_used_bytes(),
                    pool.host_free_bytes(), pool.swap_out_count,
                    pool.swap_in_count, pool.swap_out_bytes,
                    pool.swap_in_bytes)


def _page_rows(pool, ids):
    """Pages ``ids`` of every leaf as (name, f32 numpy) pairs, either
    package."""
    out = []
    for per_pos in pool.pages:
        for kv in per_pos:
            for name in sorted(kv):
                arr = kv[name]
                if isinstance(arr, torch.Tensor):
                    out.append((name, arr[:, torch.tensor(ids, dtype=torch.long)]
                                .float().numpy()))
                else:
                    out.append((name, np.asarray(
                        arr[:, jnp.asarray(ids)].astype(jnp.float32))))
    return out


def _digest(rows) -> str:
    h = hashlib.sha1()
    for name, r in rows:
        h.update(name.encode() + np.ascontiguousarray(r).tobytes())
    return h.hexdigest()


def _write_pages(pool, ids, seed):
    """Seeded contents on pages ``ids`` of every leaf, either package."""
    rng = np.random.default_rng(seed)
    new_pages = []
    for per_pos in pool.pages:
        new_pos = []
        for kv in per_pos:
            leaf = {}
            for name in sorted(kv):
                arr = kv[name]
                shape = (arr.shape[0], len(ids)) + tuple(arr.shape[2:])
                if "int8" in str(arr.dtype):
                    rows = rng.integers(-127, 128, shape).astype(np.int8)
                else:
                    rows = rng.uniform(0.01, 1.0, shape).astype(np.float32)
                if isinstance(arr, torch.Tensor):
                    arr[:, torch.tensor(ids, dtype=torch.long)] = \
                        torch.from_numpy(rows).to(arr.dtype)
                    leaf[name] = arr
                else:
                    leaf[name] = arr.at[:, jnp.asarray(ids)].set(
                        jnp.asarray(rows).astype(arr.dtype))
            new_pos.append({n: leaf[n] for n in kv})
        new_pages.append(tuple(new_pos))
    pool.pages = new_pages


def _valid_ids(pool, slot):
    sid = int(pool.seq_ids[slot])
    pages = list(pool.alloc._seq_pages[sid])
    return pages[:pool.pages_for(max(int(pool.lengths[slot]), 1))]


def _op_sequence(case, n_ops=70, n_kinds=6):
    rng = np.random.default_rng(100 + case)
    bases = [rng.integers(0, 64, 9) for _ in range(2)]
    ops = []
    for _ in range(n_ops):
        op = int(rng.integers(0, n_kinds))
        b = bases[int(rng.integers(0, 2))]
        prompt = np.concatenate([b[:int(rng.integers(1, 10))],
                                 rng.integers(0, 64, int(rng.integers(0, 4)))])
        ops.append((op, prompt.astype(np.int32), int(rng.integers(0, 5)),
                    int(rng.integers(0, 1000)), int(rng.integers(0, 64))))
    return ops


def _apply(pool, op, prompt, new, pick, tok, live, tier=None):
    """One op on a stack; returns what it returned (compared across the two
    packages). ``live``: slot -> (seq_id, prompt, max_new); ``tier`` (a
    tiered stack): the cold requests, the pending resumes and the page
    bytes each cold sequence left with."""
    acts = sorted(live)
    slot = acts[pick % len(acts)] if acts else None
    if op >= 6:
        return _apply_tier(pool, op, pick, tok, live, slot, tier)
    if op == 0:                                    # admit, prefix-matched
        L = len(prompt)
        m = pool.match(prompt) if pool.prefix is not None else None
        shared, mlen = (list(m.pages), m.length) if m else ([], 0)
        if not pool.can_admit_prefill(L, new, len(shared), mlen):
            return ("refused",)
        sid = 1000 + len(live) + pick
        if sid in pool.alloc._seq_pages or (tier and sid in tier["cold"]):
            return ("dup",)
        s = pool.admit_prefill(sid, L, shared_pages=shared, match_len=mlen)
        pool.lengths[s] = L
        live[s] = (sid, prompt, new)
        return ("admit", s, mlen)
    if slot is None:
        return ("idle",)
    sid, p, new0 = live[slot]
    if op == 1:                                    # promote
        return ("reserve", pool.reserve_decode(sid, len(p), new0))
    if op == 2:                                    # grow, COW first
        if not pool.has_decode_reservation(sid, len(p), new0):
            return ("no-reservation",)
        n = int(pool.lengths[slot])
        if n + 1 > min(len(p) + max(new0, 1), pool.max_seq):
            return ("full",)
        forked = pool.cow_unshare(slot, n)
        pool.ensure(slot, n + 1)                   # must never fail
        pool.lengths[slot] = n + 1
        return ("grow", forked)
    if op == 3 and pool.prefix is not None:        # index the prompt
        if int(pool.lengths[slot]) != len(p):
            return ("mid-decode",)
        return ("insert", pool.insert(sid, p, tok))
    if op == 4:                                    # release
        pool.release(slot)
        del live[slot]
        return ("release",)
    if op == 5 and pool.prefix is not None:
        return ("evict", pool.evict_cached(1 + pick % 2,
                                           require_free=bool(pick % 3)))
    return ("noop",)


def _apply_tier(pool, op, pick, tok, live, slot, tier):
    """The swap ops: page writes, swap-out, swap-in start and finish. A
    finish checks that the resumed pages hold the bytes the sequence left
    with and returns their digest (compared across the packages)."""
    if op == 6:                                    # write, then swap out
        if slot is None:
            return ("idle",)
        ids = _valid_ids(pool, slot)
        _write_pages(pool, ids, tok)
        if not pool.can_swap_out(slot):
            return ("no-budget", _digest(_page_rows(pool, ids)))
        saved = _page_rows(pool, ids)
        sid = pool.swap_out(slot)
        tier["cold"][sid] = (live.pop(slot), saved)
        return ("swap_out", sid, _digest(saved))
    if op == 7:                                    # start a resume
        pending = {p.seq_id for p in tier["pending"]}
        cold = sorted(set(tier["cold"]) - pending)
        if not cold:
            return ("no-cold",)
        sid = cold[pick % len(cold)]
        if not pool.can_resume(sid):
            return ("no-room", sid)
        tier["pending"].append(pool.swap_in_start(sid))
        return ("start", sid, tier["pending"][-1].slot)
    if op == 8 and tier["pending"]:                # land the oldest resume
        p = tier["pending"].pop(0)
        slot = pool.swap_in_finish(p)
        entry, saved = tier["cold"].pop(p.seq_id)
        live[slot] = entry
        rows = _page_rows(pool, _valid_ids(pool, slot))
        for (n0, r0), (n1, r1) in zip(saved, rows):
            assert n0 == n1
            np.testing.assert_array_equal(r0, r1)
        return ("finish", slot, _digest(rows))
    return ("noop",)


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stacks_conform_and_close_like_the_reference(name):
    tiered = "tiered" in name
    swaps = 0
    for case in range(3):
        tpool, jpool = _stacks(name)
        assert isinstance(tpool, tcache.CacheManager)
        assert tpool.page_tokens == 4 and tpool.max_batch == 3
        leaf = tpool.pages[0][0]
        if "int8" in name:
            assert leaf["k"].dtype == torch.int8
            assert tuple(leaf["k_scale"].shape) == tuple(leaf["k"].shape[:3])
        else:
            assert set(leaf) == {"k", "v"}
        tlive, jlive = {}, {}
        ttier, jtier = [dict(cold={}, pending=[]) if tiered else None
                        for _ in range(2)]
        for op in _op_sequence(case, n_kinds=9 if tiered else 6):
            got = _apply(tpool, *op, tlive, ttier)
            assert got == _apply(jpool, *op, jlive, jtier), (case, op)
            tpool.alloc.audit()
            assert _state(tpool) == _state(jpool)
        if tiered:
            swaps += tpool.swap_in_count
            for p in ttier["pending"]:
                tlive[tpool.swap_in_finish(p)] = None
            for sid in list(ttier["cold"]):
                if not tpool.is_cold(sid):
                    continue
                tpool.drop_cold(sid)
            assert not tpool.cold_seqs() and tpool.host_used_bytes() == 0
            assert tpool.hero.levels[3].in_use() == 0
        for slot in sorted(tlive):
            tpool.release(slot)
        a = tpool.alloc
        assert a._seq_pages == {} and (tpool.seq_ids == -1).all()
        a.audit()
        if tpool.prefix is None:
            assert a.free_pages == a.n_pages
            continue
        cached = tpool.prefix.cached_pages()
        assert len(cached) == len(set(cached)) == tpool.prefix.held_pages
        assert all(a.refcount(p) == 1 for p in cached)
        assert a.free_pages == a.n_pages - len(cached)
        tpool.prefix.clear()
        assert tpool.prefix.held_pages == 0 and a.free_pages == a.n_pages
        a.audit()
    assert swaps > 0 or not tiered


def test_cow_fork_copies_payload_and_scales():
    """A fork of a shared page copies every leaf (int8 rows and their scale
    rows) to the fresh page; an allocation zeroes the scale rows."""
    tpool, _ = _stacks("int8_prefix")
    pool = tpool
    prompt = np.arange(6, dtype=np.int32)          # 1 full page + 2 tokens
    s0 = tpool.admit_prefill(0, 6)
    tpool.lengths[s0] = 6
    pages = list(tpool.alloc._seq_pages[0])
    for kv in pool.pages[0]:
        for arr in kv.values():
            arr[:, pages] = 3
    assert tpool.insert(0, prompt, first_token=9) == 2
    m = tpool.match(prompt)
    assert m.length == 6 and m.first_token == 9
    s1 = tpool.admit_prefill(1, 6, shared_pages=m.pages, match_len=6)
    assert tpool.cow_unshare(s1, 6)
    new = tpool.alloc._seq_pages[1][1]
    assert new not in pages
    for kv in pool.pages[0]:
        for arr in kv.values():
            assert torch.equal(arr[:, new], arr[:, pages[1]])
    tpool.release(s1)
    tpool.release(s0)
    tpool.prefix.clear()
    s2 = tpool.admit_prefill(2, 12)
    for p in tpool.alloc._seq_pages[2]:
        for kv in pool.pages[0]:
            assert not kv["k_scale"][:, p].any()
            assert not kv["v_scale"][:, p].any()


# --------------------------------------------------------------------------
# the engine on a prefix stack
# --------------------------------------------------------------------------
def _prefix_schedule(rng_seed, n_req, n_pages, vocab, pt=8, max_seq=64):
    """Requests draw one of two shared prefixes and append a (possibly
    empty) suffix: empty suffixes collide into exact duplicates (full hits).
    Shapes are clamped to be admissible, as the reference's schedules are."""
    rng = np.random.default_rng(rng_seed)
    prefixes = [rng.integers(0, vocab, int(rng.integers(1, 2 * pt + 3)))
                for _ in range(2)]
    sched = []
    for _ in range(n_req):
        arrival, pick = int(rng.integers(0, 10)), int(rng.integers(0, 2))
        prompt = np.concatenate([prefixes[pick], rng.integers(
            0, vocab, int(rng.integers(0, 9)))]).astype(np.int32)
        mn = int(rng.integers(1, 5))
        worst = -(-min(len(prompt) + mn, max_seq) // pt)
        if worst > min(n_pages, max_seq // pt) or len(prompt) >= max_seq:
            prompt, mn = prompt[:pt], 1
        sched.append((arrival, prompt, mn))
    return sched


def _special_schedules(vocab):
    rng = np.random.default_rng(3)
    dup = rng.integers(0, vocab, 13).astype(np.int32)
    rng = np.random.default_rng(9)
    shared = rng.integers(0, vocab, 10)
    capped = [(3 * i, np.concatenate([shared, rng.integers(
        0, vocab, 4 + i)]).astype(np.int32), 2) for i in range(4)]
    rng = np.random.default_rng(17)
    system = rng.integers(0, vocab, 13)
    staggered = [(6 * i, np.concatenate([system, rng.integers(
        0, vocab, 3 + i)]).astype(np.int32), 4) for i in range(3)]
    staggered.append((24, staggered[0][1].copy(), 4))   # an exact repeat
    return {
        # name -> (schedule, token_budget, n_slots, n_pages, cache pages)
        "full_hit": ([(0, dup.copy(), 3), (30, dup.copy(), 3)], 8, 2, 12, 6),
        "cap_evicts": (capped, 10, 2, 14, 2),
        # a 13-token system prompt (a match ending mid-page: COW), staggered
        # arrivals, and an exact repeat of the first prompt (a full hit)
        "system_prompt": (staggered, 12, 3, 20, 10),
    }


def _cases():
    vocab = _weights()[0].vocab
    out = dict(_special_schedules(vocab))
    rng = np.random.default_rng(23)
    for case in range(3):
        n_slots = int(rng.integers(2, 5))
        budget = int(rng.integers(n_slots + 1, 22))
        n_pages = int(rng.integers(10, 20))
        n_req = int(rng.integers(3, 7))
        out[f"seeded{case}"] = (
            _prefix_schedule(200 + case, n_req, n_pages, vocab), budget,
            n_slots, n_pages, max(2, n_pages // 2))
    return out


CASES = ("full_hit", "cap_evicts", "system_prompt", "seeded0", "seeded1",
         "seeded2")


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


@functools.lru_cache(maxsize=None)
def _jax_prefix_run(name, kv_dtype, overlap):
    cfg, tree = _weights()
    sched, budget, slots, pages, cap = _cases()[name]
    eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  config=JEngineConfig(
                      n_slots=slots, max_seq=64, chunked=True,
                      token_budget=budget, overlap=overlap,
                      cache=JCacheConfig(paged=True, prefix=True,
                                         prefix_pages=cap, page_tokens=8,
                                         n_pages=pages, kv_dtype=kv_dtype)))
    streams = _drive(eng, JRequest, sched)
    return streams, {k: eng.stats[k] for k in COUNTERS}


def _port_prefix_engine(slots, budget, pages, cap, overlap, kv_dtype):
    tcfg = tconfigs.get_smoke_config("qwen2-0.5b",
                                     compute_dtype=torch.float32)
    return tengine.Engine(
        tcfg, params_from_numpy(_weights()[1], tcfg), device="cpu",
        config=tengine.EngineConfig(
            n_slots=slots, max_seq=64, chunked=True, token_budget=budget,
            overlap=overlap,
            cache=tcache.CacheConfig(page_tokens=8, n_pages=pages,
                                     prefix=True, prefix_pages=cap,
                                     kv_dtype=kv_dtype)))


def _check_closed(eng, sched):
    """Accounting closes at drain: prompt tokens are chunk-prefilled or
    adopted, one reference is left per cached page, clear() frees all."""
    s = eng.stats
    assert s["prefill_chunk_tokens"] >= \
        sum(len(p) for _, p, _ in sched) - s["prefix_shared_tokens"]
    if s["evictions_reprefill"] == 0:
        assert s["prefill_chunk_tokens"] == \
            sum(len(p) for _, p, _ in sched) - s["prefix_shared_tokens"]
    summ = eng.stats_summary()
    assert summ["max_iter_tokens"] <= summ["token_budget"]
    a = eng.pool.alloc
    assert a._seq_pages == {} and eng.pool._reserved == {}
    cached = eng.prefix.cached_pages()
    assert len(cached) == len(set(cached)) == eng.prefix.held_pages
    assert all(a.refcount(p) == 1 for p in cached)
    assert a.free_pages == a.n_pages - len(cached)
    a.audit()
    eng.prefix.clear()
    assert a.free_pages == a.n_pages
    a.audit()


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("name", CASES)
def test_prefix_engine_matches_jax_engine(name, overlap):
    sched, budget, slots, pages, cap = _cases()[name]
    streams, counters = _jax_prefix_run(name, "compute", overlap)
    eng = _port_prefix_engine(slots, budget, pages, cap, overlap, "compute")
    assert _drive(eng, tengine.Request, sched) == streams
    assert {k: eng.stats[k] for k in COUNTERS} == counters
    if not name.startswith("seeded"):
        assert counters["prefix_hits"] > 0 and counters["cow_forks"] > 0
    if name == "full_hit":
        assert counters["prefix_full_hits"] == 1
        assert counters["prefix_shared_tokens"] == len(sched[0][1])
        assert counters["prefill_chunk_tokens"] == len(sched[0][1])
        assert counters["cow_forks"] >= 1
    if name == "cap_evicts":
        assert eng.prefix.held_pages <= cap
        assert eng.prefix.evicted_pages > 0
    snap = eng.metrics_snapshot()["gauges"]
    assert snap["prefix_hit_rate"] == \
        counters["prefix_hits"] / len(eng.stats["admission_order"])
    _check_closed(eng, sched)


def _drive_non_greedy(eng, request_cls, schedule, flip_at):
    """``_drive``, with the scheduler's ``greedy`` set False from iteration
    ``flip_at`` on (None: as configured)."""
    pending = sorted(enumerate(schedule), key=lambda t: (t[1][0], t[0]))
    done, it = [], 0
    while True:
        if it == flip_at:
            eng.scheduler.greedy = False
        while pending and pending[0][1][0] <= it:
            sid, (_, prompt, max_new) = pending.pop(0)
            assert eng.submit(request_cls(seq_id=sid, prompt=prompt.copy(),
                                          max_new=max_new))
        if not pending and eng.idle:
            return {r.seq_id: list(r.tokens_out) for r in done}
        done.extend(eng.step())
        it += 1
        assert it <= 4000


@pytest.mark.parametrize("flip", [None, "repeat"],
                         ids=["non_greedy", "greedy_then_not"])
@pytest.mark.parametrize("name", ["full_hit", "system_prompt"])
def test_non_greedy_prefix_engine_matches_jax_engine(name, flip):
    """``EngineConfig(greedy=False)``: nothing is indexed, so no prompt
    hits; and a greedy engine turned non-greedy before the exact
    re-arrival: the match is trimmed by one position (no full hit, the
    first token computed again). Streams and prefix counters equal the
    JAX engine's either way, and the streams are the greedy run's."""
    sched, budget, slots, pages, cap = _cases()[name]
    flip_at = None if flip is None else sched[-1][0]
    runs = []
    cfg, tree = _weights()
    for pkg in ("jax", "port"):
        kw = dict(n_slots=slots, max_seq=64, chunked=True,
                  token_budget=budget, greedy=flip is not None)
        ckw = dict(page_tokens=8, n_pages=pages, prefix=True,
                   prefix_pages=cap)
        if pkg == "jax":
            eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                          config=JEngineConfig(
                              **kw, cache=JCacheConfig(paged=True, **ckw)))
        else:
            tcfg = tconfigs.get_smoke_config("qwen2-0.5b",
                                             compute_dtype=torch.float32)
            eng = tengine.Engine(tcfg, params_from_numpy(tree, tcfg),
                                 device="cpu", config=tengine.EngineConfig(
                                     **kw, cache=tcache.CacheConfig(**ckw)))
        streams = _drive_non_greedy(
            eng, JRequest if pkg == "jax" else tengine.Request, sched,
            flip_at)
        runs.append((streams, {k: eng.stats[k] for k in COUNTERS}))
        assert eng.greedy is False
    assert runs[1] == runs[0]
    streams, counters = runs[1]
    assert streams == _jax_prefix_run(name, "compute", True)[0]
    assert counters["prefix_full_hits"] == 0
    if flip is None:
        assert counters["prefix_hits"] == 0
        assert counters["prefill_chunk_tokens"] == \
            sum(len(p) for _, p, _ in sched)
    else:       # the repeat matched all but its last position
        assert counters["prefix_hits"] >= 1
        assert counters["prefix_shared_tokens"] >= len(sched[-1][1]) - 1
    _check_closed(eng, sched)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_int8_prefix_engine_matches_jax_engine(overlap):
    """int8 pages under the prefix layer: shared pages carry their scales;
    streams and counters equal the reference's int8 + prefix engine."""
    sched, budget, slots, pages, cap = _cases()["system_prompt"]
    streams, counters = _jax_prefix_run("system_prompt", "int8", overlap)
    eng = _port_prefix_engine(slots, budget, pages, cap, overlap, "int8")
    assert _drive(eng, tengine.Request, sched) == streams
    assert {k: eng.stats[k] for k in COUNTERS} == counters
    assert counters["prefix_hits"] == 3 and counters["prefix_full_hits"] == 1
    assert counters["cow_forks"] > 0
    _check_closed(eng, sched)


def _slot_shortage(eng, request_cls):
    """A donor warms the cache, two long decodes take both slots, a fourth
    request arrives into the full house: the refusals are slot-bound and
    must not evict the cache. Returns the streams."""
    vocab = _weights()[0].vocab
    rng = np.random.default_rng(41)
    shared = rng.integers(0, vocab, 16)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, 2 + i)])
               .astype(np.int32) for i in range(4)]
    news = (1, 12, 12, 2)
    eng.submit(request_cls(seq_id=0, prompt=prompts[0], max_new=news[0]))
    done = eng.run(max_steps=200)
    held0 = eng.prefix.held_pages
    assert held0 > 0
    eng.submit(request_cls(seq_id=1, prompt=prompts[1], max_new=news[1]))
    eng.submit(request_cls(seq_id=2, prompt=prompts[2], max_new=news[2]))
    done += eng.step()
    eng.submit(request_cls(seq_id=3, prompt=prompts[3], max_new=news[3]))
    for _ in range(3):
        done += eng.step()
    assert eng.stats["admission_refusals"] >= 1
    assert eng.prefix.evicted_pages == 0
    assert eng.prefix.held_pages >= held0
    done += eng.run(max_steps=400)
    assert len(done) == 4 and eng.idle
    return {r.seq_id: list(r.tokens_out) for r in done}


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_slot_shortage_does_not_flush_the_prefix_cache(overlap):
    """A slot-bound admission refusal never evicts the prefix cache (pages
    are not the binding constraint); streams and counters equal the
    reference engine's through the same submissions and steps."""
    cfg, tree = _weights()
    jeng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                   config=JEngineConfig(
                       n_slots=2, max_seq=64, chunked=True, token_budget=24,
                       overlap=overlap,
                       cache=JCacheConfig(paged=True, prefix=True,
                                          prefix_pages=8, page_tokens=8,
                                          n_pages=32)))
    eng = _port_prefix_engine(2, 24, 32, 8, overlap, "compute")
    assert _slot_shortage(eng, tengine.Request) == \
        _slot_shortage(jeng, JRequest)
    assert {k: eng.stats[k] for k in COUNTERS} == \
        {k: jeng.stats[k] for k in COUNTERS}
    assert eng.stats["prefix_hits"] >= 3
