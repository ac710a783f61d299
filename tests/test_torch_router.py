"""The port's fleet (serve/router.py, serve/replica.py) against the JAX fleet.

Every case of the reference's conformance and fault-injection suite
(tests/test_router.py) runs here on both fleets: the JAX ``Fleet`` (Pallas
in interpret mode) and the port's ``Fleet`` on the CPU, at the smoke config
in f32, with the reference's weights carried across by
``models/convert.py`` and the reference's ``_mix`` / ``_drive`` schedules
rebuilt from the same numpy seeds. Each case holds the port to the JAX
fleet, not only to its own single engine:

  * the per-request greedy streams;
  * ``fleet.stats`` (routed, prefix-routed and their tokens, requeues,
    backpressure waits, respawns);
  * placements: the replica every submission lands on, in order (requeued
    requests included);
  * the shed verdicts, by sequence id and code;

and each keeps the reference's own assertions (streams equal to a single
engine's, zero loss, the allocator audit clean on every replica).

The reference's tensor-parallel case (``test_fleet_streams_bit_identical_tp``,
``tests/test_router.py:167``) runs the port's fleet at tp = 2: two gloo
ranks, each stepping the same two replicas over one process group
(parallel/launch.py), held against the JAX single engine and fleet at
tp = 1, whose tp path raises on the installed JAX (ROADMAP.md §3).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.serve import prefix_cache as jprefix
from repro.serve import replica as jreplica
from repro.serve import router as jrouter
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.metrics import MetricsBus as JMetricsBus
from repro.serve.policy import PolicyConfig as JPolicyConfig
from repro_torch import configs as tconfigs
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import prefix_cache as tprefix
from repro_torch.serve import replica as treplica
from repro_torch.serve import router as trouter
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.metrics import MetricsBus as TMetricsBus
from repro_torch.serve.policy import PolicyConfig as TPolicyConfig

_CFG = jconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=jnp.float32)
_TCFG = tconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _tree():
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), _CFG))[0]
    return jax.tree_util.tree_map(np.array, params)


@functools.lru_cache(maxsize=None)
def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _tree())


@functools.lru_cache(maxsize=None)
def _model():
    return params_from_numpy(_tree(), _TCFG)


# each side: its engine, fleet and config classes, and how it builds them
JAX = types.SimpleNamespace(
    name="jax", Engine=JEngine, EngineConfig=JEngineConfig,
    CacheConfig=JCacheConfig, PolicyConfig=JPolicyConfig, Request=JRequest,
    Fleet=jrouter.Fleet, Replica=jreplica.Replica, MetricsBus=JMetricsBus,
    prefix=jprefix, states=jreplica,
    engine=lambda econf: JEngine(_CFG, _jparams(), config=econf),
    fleet=lambda econf, **kw: jrouter.Fleet(_CFG, _jparams(), econf, **kw))
PORT = types.SimpleNamespace(
    name="port", Engine=TEngine, EngineConfig=TEngineConfig,
    CacheConfig=TCacheConfig, PolicyConfig=TPolicyConfig, Request=TRequest,
    Fleet=trouter.Fleet, Replica=treplica.Replica, MetricsBus=TMetricsBus,
    prefix=tprefix, states=treplica,
    engine=lambda econf: TEngine(_TCFG, _model(), config=econf,
                                 device="cpu"),
    fleet=lambda econf, **kw: trouter.Fleet(_TCFG, _model(), econf,
                                            device="cpu", **kw))
SIDES = (JAX, PORT)


# --------------------------------------------------------------------------
# the reference's schedules and drivers, for either side
# --------------------------------------------------------------------------
def _mix(side, seed, n=8, shared_len=12, spread=2):
    """(arrival_iter, Request): ragged arrivals over a shared system prompt
    (``tests/test_router.py:60``, the same draws)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, _CFG.vocab, shared_len)
    sched = []
    for i in range(n):
        suffix = rng.integers(0, _CFG.vocab, 2 + int(rng.integers(0, 4)))
        sched.append((spread * i, side.Request(
            seq_id=i,
            prompt=np.concatenate([shared, suffix]).astype(np.int32),
            max_new=3 + int(rng.integers(0, 4)))))
    return sched


def _drive(target, schedule, max_iters=2000, hook=None):
    """Feed arrivals into an Engine or a Fleet; ``hook(it)`` runs before
    each step (``tests/test_router.py:76``)."""
    pending = sorted(schedule, key=lambda t: t[0])
    done, it = [], 0
    while True:
        while pending and pending[0][0] <= it:
            assert target.submit(pending[0][1])
            pending.pop(0)
        if hook is not None:
            hook(it)
        if not pending and target.idle:
            return done
        done.extend(target.step())
        it += 1
        assert it <= max_iters, "workload did not drain"


def _stacks(side):
    E, C = side.EngineConfig, side.CacheConfig
    return {
        "chunked": E(n_slots=2, max_seq=64, chunked=True, token_budget=12,
                     cache=C(paged=True, page_tokens=8, n_pages=24)),
        "tiered": E(n_slots=2, max_seq=64, chunked=True, token_budget=12,
                    preempt_quantum=1,
                    cache=C(page_tokens=8, n_pages=8, tiered=True)),
        "prefix": E(n_slots=2, max_seq=64, token_budget=12,
                    cache=C(paged=True, page_tokens=8, n_pages=24,
                            prefix=True, prefix_pages=6)),
    }


def _streams(done):
    return {r.seq_id: list(r.tokens_out) for r in done}


def _record_placements(fleet):
    """Log (seq_id, replica) for every submission a replica accepts, in
    order; a respawned replica keeps its handle, so the log survives it."""
    log = []
    for rep in fleet.replicas:
        def submit(req, rep=rep, inner=rep.submit):
            ok = inner(req)
            if ok:
                log.append((int(req.seq_id), rep.name))
            return ok
        rep.submit = submit
    return log


def _outcome(fleet, done, log):
    return {"streams": _streams(done), "stats": dict(fleet.stats),
            "placements": list(log),
            "shed": [(int(r.seq_id), r.verdict.code) for r in fleet.shed],
            "finished": sorted(int(r.seq_id) for r in fleet.finished)}


def _assert_zero_loss(fleet, schedule):
    """Every submitted request ended exactly one of finished / shed, and a
    shed one carries a typed verdict (``tests/test_router.py:112``)."""
    submitted = {req.seq_id for _, req in schedule}
    fin = {r.seq_id for r in fleet.finished}
    shed = {r.seq_id for r in fleet.shed}
    assert fin | shed == submitted, "request lost by the fleet"
    assert not (fin & shed), "request both finished and shed"
    assert not fleet._pending and not fleet._inflight
    for r in fleet.shed:
        assert r.verdict is not None and r.verdict.code in (
            "overload", "deadline"), f"untyped shed verdict on {r.seq_id}"
    for r in fleet.finished:
        assert r.done and r.tokens_out


def _drain_all_and_audit(side, fleet):
    """Drain every live replica, step the corpses dead, audit each
    allocator (``tests/test_router.py:129``)."""
    for rep in fleet.replicas:
        if rep.state == side.states.READY:
            fleet.drain(rep.name)
    fleet.run(50)
    for rep in fleet.replicas:
        assert rep.state == side.states.DEAD, \
            f"{rep.name} stuck in {rep.state}"
        if rep.engine is not None and hasattr(rep.engine.pool, "alloc"):
            rep.engine.pool.alloc.audit()
            assert rep.engine.pool.alloc._seq_pages == {}, \
                f"{rep.name} leaked sequence pages"


def _both(run):
    """``run(side)`` on the JAX fleet and on the port's; the port's outcome
    must equal the reference's. Returns the port's."""
    ref, got = run(JAX), run(PORT)
    for key in ("streams", "stats", "placements", "shed", "finished"):
        assert got[key] == ref[key], (key, got[key], ref[key])
    return got


# --------------------------------------------------------------------------
# routed-vs-single conformance across cache stacks (tests/test_router.py:148)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("router", ["prefix", "round_robin"])
@pytest.mark.parametrize("stack", ["chunked", "prefix", "tiered"])
def test_fleet_streams_match_jax_fleet_and_single(stack, router):
    single = _streams(_drive(PORT.engine(_stacks(PORT)[stack]),
                             _mix(PORT, 0)))

    def run(side):
        fleet = side.fleet(_stacks(side)[stack], replicas=2, router=router)
        log = _record_placements(fleet)
        sched = _mix(side, 0)
        done = _drive(fleet, sched)
        _assert_zero_loss(fleet, sched)
        assert fleet.stats["routed"] == len(sched)
        snaps = fleet.metrics_snapshot()
        assert {s["namespace"] for s in snaps.values()} == {"r0", "r1"}
        out = _outcome(fleet, done, log)
        _drain_all_and_audit(side, fleet)
        return out

    got = _both(run)
    assert got["streams"] == single, f"{stack}/{router}: routed streams " \
        "diverged from one engine's"


@pytest.mark.parametrize("tp", [2])
def test_fleet_streams_bit_identical_tp(tp, tmp_path):
    """``tests/test_router.py:166`` at tp = 2: a two-replica fleet whose
    engines shard their kv heads over the same two ranks gives one JAX
    engine's streams at tp = 1 and the JAX fleet's counters; every request
    finishes, and each replica drains dead with a clean allocator on
    every rank."""
    from repro_torch.parallel import launch
    from repro_torch.parallel.tp_jobs import (ServeJob, replicated,
                                              serve_schedule)

    def econf(side, tp):
        return side.EngineConfig(
            n_slots=2, max_seq=64, chunked=True, token_budget=10,
            cache=side.CacheConfig(paged=True, page_tokens=8, n_pages=16),
            **({"tp": tp, "check_ranks": True} if side is PORT else {}))

    ref = _streams(_drive(JAX.engine(econf(JAX, 1)), _mix(JAX, 1, n=6)))
    jfleet = JAX.fleet(econf(JAX, 1), replicas=2)
    _drive(jfleet, _mix(JAX, 1, n=6))
    sched = [(at, req.prompt, req.max_new) for at, req in _mix(PORT, 1, n=6)]
    job = ServeJob(cfg=_TCFG, weights=_tree(), config=econf(PORT, tp),
                          schedule=sched, replicas=2)
    out = launch.spawn(serve_schedule, tp, (job,),
                       store_dir=str(tmp_path), backend="gloo",
                       timeout_s=90.0)
    got = replicated(out, ("streams", "fleet", "states"))
    assert got["streams"] == ref
    assert got["fleet"] == jfleet.stats
    assert got["finished"] == list(range(6)) and not got["shed"]
    assert got["pending"] == 0
    assert set(got["states"].values()) == {treplica.DEAD}
    for state in got["replicas"].values():
        assert state["pool"]["seq_pages"] == {}
        assert state["pool"]["kv_heads"] == _TCFG.n_kv // tp
        assert state["executor"]["rank_checks"] > 0


# --------------------------------------------------------------------------
# fault injection: kill mid-decode, kill and respawn, drain
# --------------------------------------------------------------------------
def test_kill_mid_decode_requeues_to_siblings():
    """``tests/test_router.py:186``: r0 fails at the top of a step while it
    holds residents and queued work; they finish on r1."""
    single = _streams(_drive(PORT.engine(_stacks(PORT)["prefix"]),
                             _mix(PORT, 2)))

    def run(side):
        fleet = side.fleet(_stacks(side)["prefix"], replicas=2)
        log = _record_placements(fleet)
        sched = _mix(side, 2)

        def hook(it):
            if it == 4:
                fleet._by_name["r0"].fail_after(1)

        done = _drive(fleet, sched, hook=hook)
        r0 = fleet._by_name["r0"]
        assert r0.state == side.states.DEAD and r0.engine is None
        assert fleet.stats["requeued_kill"] > 0
        _assert_zero_loss(fleet, sched)
        out = _outcome(fleet, done, log)
        _drain_all_and_audit(side, fleet)
        return out

    assert _both(run)["streams"] == single


def test_explicit_kill_and_respawn_round_trip():
    """``tests/test_router.py:209``: kill r1 at iteration 3, respawn it at
    8 (generation 2)."""
    single = _streams(_drive(PORT.engine(_stacks(PORT)["chunked"]),
                             _mix(PORT, 3)))

    def run(side):
        fleet = side.fleet(_stacks(side)["chunked"], replicas=2)
        log = _record_placements(fleet)
        sched = _mix(side, 3)
        state = {"killed": False, "respawned": False}

        def hook(it):
            if it == 3 and not state["killed"]:
                fleet.kill("r1")
                state["killed"] = True
            elif it == 8 and not state["respawned"]:
                rep = fleet.respawn("r1")
                assert rep.state == side.states.READY and \
                    rep.generation == 2
                state["respawned"] = True

        done = _drive(fleet, sched, hook=hook)
        assert state["killed"] and state["respawned"]
        _assert_zero_loss(fleet, sched)
        assert fleet.stats["respawns"] == 1
        out = _outcome(fleet, done, log)
        _drain_all_and_audit(side, fleet)
        return out

    assert _both(run)["streams"] == single


def test_drain_requeues_only_stateless_requests():
    """``tests/test_router.py:235``: draining r0 on the tiered stack moves
    only never-admitted requests; residents (and cold ones) finish there,
    and the corpse keeps its engine for the audit."""
    single = _streams(_drive(PORT.engine(_stacks(PORT)["tiered"]),
                             _mix(PORT, 4, n=10, spread=1)))

    def run(side):
        fleet = side.fleet(_stacks(side)["tiered"], replicas=2)
        log = _record_placements(fleet)
        sched = _mix(side, 4, n=10, spread=1)
        moved = {}

        def hook(it):
            if it == 3:
                moved["n"] = fleet.drain("r0")
                assert fleet._by_name["r0"].state in (
                    side.states.DRAINING, side.states.DEAD)

        done = _drive(fleet, sched, hook=hook)
        _assert_zero_loss(fleet, sched)
        assert fleet.stats["requeued_drain"] == moved["n"]
        r0 = fleet._by_name["r0"]
        assert r0.state == side.states.DEAD and r0.engine is not None
        r0.engine.pool.alloc.audit()
        assert r0.engine.pool.alloc._seq_pages == {}
        out = _outcome(fleet, done, log)
        _drain_all_and_audit(side, fleet)
        return out

    assert _both(run)["streams"] == single


def test_drain_respawn_property_zero_loss():
    """``tests/test_router.py:265``, with the reference's settings: for
    drawn mixes and drain points a drain → respawn round trip loses no
    request, its streams equal one engine's, twin port fleets decide every
    placement alike, and the port fleet equals the JAX fleet."""

    @settings(max_examples=5, deadline=None, derandomize=True)
    @given(seed=st.integers(0, 10_000), n=st.integers(4, 8),
           drain_at=st.integers(1, 6))
    def prop(seed, n, drain_at):
        single = _streams(_drive(PORT.engine(_stacks(PORT)["chunked"]),
                                 _mix(PORT, seed, n=n)))

        def run(side):
            fleet = side.fleet(_stacks(side)["chunked"], replicas=2)
            log = _record_placements(fleet)
            state = {"drained": False, "respawned": False}

            def hook(it):
                if it == drain_at and not state["drained"]:
                    fleet.drain("r0")
                    state["drained"] = True
                elif (state["drained"] and not state["respawned"]
                      and fleet._by_name["r0"].state == side.states.DEAD):
                    fleet.respawn("r0")
                    state["respawned"] = True

            sched = _mix(side, seed, n=n)
            done = _drive(fleet, sched, hook=hook)
            assert state["drained"]
            _assert_zero_loss(fleet, sched)
            out = _outcome(fleet, done, log)
            _drain_all_and_audit(side, fleet)
            return out

        got = _both(run)
        twin = run(PORT)
        assert got["streams"] == single
        assert twin == got, "seeded twin fleets diverged"

    prop()


# --------------------------------------------------------------------------
# admission backpressure and typed shedding
# --------------------------------------------------------------------------
def test_backpressure_holds_fifo_until_a_replica_opens():
    """``tests/test_router.py:312``: every replica's gate at
    max_in_system=1, so later arrivals park in the fleet FIFO."""
    def econf(side):
        return side.EngineConfig(
            n_slots=2, max_seq=64, chunked=True, token_budget=12,
            policy=side.PolicyConfig(max_in_system=1),
            cache=side.CacheConfig(paged=True, page_tokens=8, n_pages=24))

    single = _streams(_drive(PORT.engine(econf(PORT)),
                             _mix(PORT, 5, spread=1)))

    def run(side):
        fleet = side.fleet(econf(side), replicas=2)
        log = _record_placements(fleet)
        sched = _mix(side, 5, spread=1)
        done = _drive(fleet, sched)
        _assert_zero_loss(fleet, sched)
        assert fleet.stats["backpressure_waits"] > 0
        assert not fleet.shed
        return _outcome(fleet, done, log)

    assert _both(run)["streams"] == single


def test_overload_shed_verdicts_are_typed():
    """``tests/test_router.py:332``: a queue-capped policy sheds the
    over-cap tail of one burst on whichever replica it was routed to; the
    port sheds the JAX fleet's requests with its codes."""
    def run(side):
        fleet = side.fleet(side.EngineConfig(
            n_slots=2, max_seq=64, chunked=True, token_budget=12,
            policy=side.PolicyConfig(max_in_system=2, max_queue=1),
            cache=side.CacheConfig(paged=True, page_tokens=8, n_pages=24)),
            replicas=2)
        log = _record_placements(fleet)
        sched = [(0, req) for _, req in _mix(side, 6, n=12)]
        done = _drive(fleet, sched)
        _assert_zero_loss(fleet, sched)
        assert fleet.shed
        assert all(r.verdict.code == "overload" for r in fleet.shed)
        assert fleet.stats_summary()["fleet"]["shed"] == len(fleet.shed)
        return _outcome(fleet, done, log)

    _both(run)


# --------------------------------------------------------------------------
# prefix fingerprints: the port's digests are the reference's
# --------------------------------------------------------------------------
def test_prompt_fingerprints_equal_the_reference():
    """``tests/test_router.py:352``: deterministic, longest first, every
    prefix length a candidate, a one-token change matching up to it; each
    digest byte for byte the reference's."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 1000, 21).astype(np.int32)
    fps = tprefix.prompt_fingerprints(prompt, 8)
    assert fps == jprefix.prompt_fingerprints(prompt, 8)
    assert fps == tprefix.prompt_fingerprints(prompt, 8)
    lens = [n for n, _ in fps]
    assert lens == sorted(lens, reverse=True)
    assert set(lens) == set(range(1, 22))
    mutated = prompt.copy()
    mutated[10] = (mutated[10] + 1) % 1000
    other = dict((d, n) for n, d in tprefix.prompt_fingerprints(mutated, 8))
    assert tprefix.longest_fingerprint_match(fps, other) == 10
    assert jprefix.longest_fingerprint_match(fps, other) == 10


def test_fingerprint_match_golden_against_real_cache():
    """``tests/test_router.py:370``: the digest map a real radix tree
    exports after one donor request equals the reference's byte for byte,
    and scores followers at the cache's reuse granularity."""
    maps = {}
    for side in SIDES:
        eng = side.engine(_stacks(side)["prefix"])
        rng = np.random.default_rng(12)
        donor = rng.integers(0, _CFG.vocab, 20).astype(np.int32)
        eng.submit(side.Request(seq_id=0, prompt=donor, max_new=3))
        eng.run(200)
        maps[side.name] = eng.prefix.fingerprints()
    fp = maps["port"]
    assert fp == maps["jax"]
    assert sorted(fp.values()) == [8, 16, 17, 18, 19, 20]

    def match(prompt):
        return tprefix.longest_fingerprint_match(
            tprefix.prompt_fingerprints(np.asarray(prompt, np.int32), 8), fp)

    tail = rng.integers(0, _CFG.vocab, 6)
    full = np.concatenate([donor, tail])
    assert match(full) == 20
    partial_tail = full.copy()
    partial_tail[18] = (partial_tail[18] + 1) % _CFG.vocab
    assert match(partial_tail) == 18
    mid_page = full.copy()
    mid_page[12] = (mid_page[12] + 1) % _CFG.vocab
    assert match(mid_page) == 8
    assert match(rng.integers(0, _CFG.vocab, 12)) == 0


# --------------------------------------------------------------------------
# placement golden cases (fake engines: no device work), on both fleets
# --------------------------------------------------------------------------
class _FakePrefix:
    def __init__(self, fps):
        self._fps = fps

    def fingerprints(self):
        return dict(self._fps)


class _FakeScheduler:
    policy = None

    def __init__(self):
        self.n_resident = 0

    def _in_system(self):
        return self.n_resident


class _FakeEngine:
    """Just the surface Replica's routing signals and submit touch."""

    def __init__(self, bus_cls):
        self.mailbox = []
        self.bus = bus_cls(enabled=False)
        self.scheduler = _FakeScheduler()
        self.prefix = None
        self.shed = []
        self.idle = True

    def submit(self, req):
        self.mailbox.append(req)
        return True

    def step(self):
        return []


def _fake_fleet(side, n=3):
    return side.Fleet(None, None, side.EngineConfig(
        cache=side.CacheConfig(paged=True, page_tokens=8)),
        replicas=n,
        engine_factory=lambda name, gen: _FakeEngine(side.MetricsBus))


def _donor_map(side, prompt, page_tokens=8):
    """The digest map a replica holding ``prompt`` exports, built with
    ``extend_digest`` (``tests/test_router.py:449``)."""
    toks = np.asarray(prompt, np.int32)
    out, d, base = {}, b"", 0
    while base + page_tokens <= len(toks):
        d = side.prefix.extend_digest(d, toks[base:base + page_tokens])
        base += page_tokens
        out[d] = base
    for j in range(1, len(toks) - base + 1):
        out[side.prefix.extend_digest(d, toks[base:base + j])] = base + j
    return out


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_pick_longest_prefix_match_wins(side):
    """``tests/test_router.py:464``."""
    fleet = _fake_fleet(side, 3)
    rng = np.random.default_rng(13)
    tenant_a = rng.integers(0, 1000, 24).astype(np.int32)
    tenant_b = rng.integers(0, 1000, 24).astype(np.int32)
    fleet._by_name["r1"].engine.prefix = _FakePrefix(
        _donor_map(side, tenant_a))
    fleet._by_name["r2"].engine.prefix = _FakePrefix(
        _donor_map(side, tenant_b))
    assert _donor_map(PORT, tenant_a) == _donor_map(JAX, tenant_a)
    follower = side.Request(seq_id=50, prompt=np.concatenate(
        [tenant_a, rng.integers(0, 1000, 5)]).astype(np.int32), max_new=2)
    assert fleet._try_place(follower)
    assert fleet._inflight[50][1] == "r1"
    assert fleet.stats["routed_prefix"] == 1
    assert fleet.stats["routed_prefix_tokens"] == 24
    follower_b = side.Request(seq_id=51, prompt=np.concatenate(
        [tenant_b, rng.integers(0, 1000, 3)]).astype(np.int32), max_new=2)
    assert fleet._try_place(follower_b)
    assert fleet._inflight[51][1] == "r2"


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_pick_falls_back_to_least_occupied_and_is_deterministic(side):
    """``tests/test_router.py:485``."""
    fleet = _fake_fleet(side, 3)
    fleet._by_name["r0"].engine.scheduler.n_resident = 2
    fleet._by_name["r1"].engine.mailbox.extend([None])      # load 1
    rng = np.random.default_rng(14)
    req = side.Request(seq_id=60, prompt=rng.integers(0, 1000, 9).astype(
        np.int32), max_new=2)
    assert fleet._try_place(req)
    assert fleet._inflight[60][1] == "r2"
    assert fleet.stats["routed_prefix"] == 0
    twin = _fake_fleet(side, 3)
    twin._by_name["r0"].engine.scheduler.n_resident = 2
    twin._by_name["r1"].engine.mailbox.extend([None])
    req2 = side.Request(seq_id=60, prompt=rng.integers(0, 1000, 9).astype(
        np.int32), max_new=2)
    assert twin._try_place(req2) and twin._inflight[60][1] == "r2"
    tie = _fake_fleet(side, 3)
    req3 = side.Request(seq_id=61, prompt=np.arange(7, dtype=np.int32),
                        max_new=2)
    assert tie._try_place(req3) and tie._inflight[61][1] == "r0"


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_round_robin_cycles_open_replicas(side):
    """``tests/test_router.py:510``."""
    fleet = _fake_fleet(side, 3)
    fleet.router = "round_robin"
    owners = []
    for i in range(6):
        req = side.Request(seq_id=70 + i, prompt=np.arange(5, dtype=np.int32),
                           max_new=1)
        assert fleet._try_place(req)
        owners.append(fleet._inflight[70 + i][1])
    assert owners == ["r0", "r1", "r2", "r0", "r1", "r2"]


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_replica_lifecycle_guards(side):
    """``tests/test_router.py:522``."""
    s = side.states
    rep = side.Replica("x", lambda name, gen: _FakeEngine(side.MetricsBus))
    with pytest.raises(RuntimeError):
        rep.start_drain()
    rep.launch()
    assert rep.state == s.READY and rep.generation == 1
    with pytest.raises(RuntimeError):
        rep.launch()
    with pytest.raises(ValueError):
        rep.fail_after(0)
    rep.engine.idle = False
    rep.start_drain()
    assert rep.state == s.DRAINING and not rep.admission_open()
    rep.step()
    assert rep.state == s.DRAINING
    rep.engine.idle = True
    rep.step()
    assert rep.state == s.DEAD and rep.engine is not None
    rep.launch()
    assert rep.state == s.READY and rep.generation == 2


# --------------------------------------------------------------------------
# the port's own: hooks the fleet reads, sharing, the CLI, the boundary
# --------------------------------------------------------------------------
def test_fleet_replicas_share_the_weights_and_respawn_fresh_state():
    fleet = PORT.fleet(_stacks(PORT)["prefix"], replicas=2)
    r0, r1 = (fleet._by_name[n] for n in ("r0", "r1"))
    assert r0.engine.model is r1.engine.model is _model()
    assert r0.engine.model.embed.data_ptr() == _model().embed.data_ptr()
    assert r0.engine.bus.namespace == "r0" and r1.engine.bus.namespace == "r1"
    pool = r1.engine.pool
    fleet.kill("r1")
    fleet.respawn("r1")
    assert r1.engine.model is _model() and r1.engine.pool is not pool
    assert r1.generation == 2


def test_engine_fleet_hooks():
    """``normalized()``, the mailbox, ``extract_unadmitted`` (never-admitted
    requests only, the rest kept in order) and a disabled bus."""
    conf = TEngineConfig(cache=TCacheConfig(prefix=True))
    n = conf.normalized()
    assert n.chunked and n.cache.paged and n.overlap
    assert TEngineConfig(chunked=True).normalized().cache.paged
    assert not TEngineConfig().normalized().cache.paged
    assert not TEngineConfig().normalized().overlap
    assert TEngineConfig(cache=TCacheConfig(kv_dtype="int8")).normalized(
    ).cache.paged
    eng = PORT.engine(_stacks(PORT)["chunked"])
    reqs = [r for _, r in _mix(PORT, 7, n=4)]
    for r in reqs:
        eng.submit(r)
    assert len(eng.mailbox) == 4
    eng.step()                          # admits two, both hold pages
    eng.scheduler._ever_admitted.add(reqs[3].seq_id)   # as a returnee would
    moved = eng.scheduler.extract_unadmitted()
    assert [r.seq_id for r in moved] == [2]
    assert len(eng.mailbox) == 1
    quiet = PORT.engine(TEngineConfig(
        n_slots=2, max_seq=64, chunked=True, token_budget=12, metrics=False,
        cache=TCacheConfig(page_tokens=8, n_pages=24)))
    loud = PORT.engine(_stacks(PORT)["chunked"])
    assert _streams(_drive(quiet, _mix(PORT, 8))) == \
        _streams(_drive(loud, _mix(PORT, 8)))
    assert quiet.metrics_snapshot() == {} and loud.metrics_snapshot()


def test_serve_cli_fleet_on_the_cpu(capsys):
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--requests", "6", "--slots", "2",
              "--max-seq", "32", "--max-new", "3", "--page-tokens", "8",
              "--token-budget", "8", "--prefix-cache",
              "--shared-prefix-len", "8", "--prompt-len", "2",
              "--replicas", "2"]
    serve.main(common + ["--router", "prefix"])
    out = capsys.readouterr().out
    head = [ln for ln in out.splitlines()
            if ln.startswith("[serve:fleet] 2 replicas (prefix router): ")]
    assert len(head) == 1 and "6 requests, 18 tokens" in head[0]
    assert sum(ln.startswith("[serve:fleet]   r") for ln in
               out.splitlines()) == 2
    serve.main(common + ["--router", "round_robin"])
    assert "[serve:fleet] 2 replicas (round_robin router): 6 requests" in \
        capsys.readouterr().out
    for extra in (["--profile", "3"], ["--trace", "unused.json"]):
        with pytest.raises(SystemExit):
            serve.main(common + extra)
        assert "do not combine with --replicas" in capsys.readouterr().err
