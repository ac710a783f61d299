"""The SLO policy in the port, held against the JAX reference.

  * ``SchedulerPolicy`` (a copy of the reference's) gives the reference's
    plans on the same queues over many passes: kept order, shed verdicts
    (code, reason, time), aging, the admission gate and the ITL squeeze;
  * the port's chunked engine behind a policy gives the JAX chunked
    engine's streams, admission order and counters on seeded cases of the
    reference's three policy properties (streams and budget under priority
    and deadline mixes with and without the ITL squeeze; admissions in
    priority order; aging bounds a low class's wait);
  * the chunked shedding mix (the reference's tiered oversubscription
    replay with ``chunked=True``): without the policy the port's refusals
    and preemptions equal JAX's; behind ``PolicyConfig(max_in_system=2,
    max_queue=4)`` its shed ``(seq_id, code)`` list equals JAX's, with no
    refusal;
  * the serve CLI's tier and policy flags on the CPU.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import policy as jpolicy
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.kvcache import token_bytes
from repro.serve.metrics import MetricsBus as JBus
from repro_torch import configs as tconfigs
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine
from repro_torch.serve import policy as tpolicy
from repro_torch.serve.metrics import MetricsBus as TBus

from test_torch_engine import _weights

COUNTERS = ("admission_refusals", "preemptions", "swap_out_count",
            "swap_in_count", "decode_steps", "prefill_chunk_tokens",
            "evictions_reprefill", "shed")


# --------------------------------------------------------------------------
# the policy object
# --------------------------------------------------------------------------
def _plan_trace(mod, bus_cls, seed):
    """Many admission passes over a seeded arrival stream: each pass plans
    the line, admits its head under the gate, and records everything the
    plan decided."""
    rng = np.random.default_rng(seed)
    cfg = mod.PolicyConfig(age_iters=int(rng.integers(1, 4)),
                           max_in_system=int(rng.integers(1, 4)),
                           max_queue=int(rng.integers(0, 4)),
                           itl_target_s=0.05)
    bus = bus_cls()
    pol = mod.SchedulerPolicy(cfg, bus=bus)
    line, in_system, sid, out = [], 0, 0, []
    held = set()                                  # "ever admitted" seq_ids
    for step in range(30):
        now = float(step)
        for _ in range(int(rng.integers(0, 4))):
            line.append(types.SimpleNamespace(
                seq_id=sid, priority=int(rng.integers(0, 3)), t_submit=now,
                deadline_s=(float(rng.integers(1, 6))
                            if rng.random() < 0.3 else None)))
            sid += 1
        keep, shed = pol.plan(list(line), now=now, in_system=in_system,
                              sheddable=lambda r: r.seq_id not in held)
        out.append(([r.seq_id for r in keep],
                     [(r.seq_id, v.code, v.reason, v.t_shed)
                      for r, v in shed],
                     [pol.effective_priority(r) for r in keep]))
        line = keep
        while line and pol.may_admit(in_system):
            req = line.pop(0)
            pol.note_admitted(req)
            held.add(req.seq_id)
            in_system += 1
        if rng.random() < 0.4 and in_system:
            in_system -= 1
            back = min(held)
            if rng.random() < 0.5 and all(r.seq_id != back for r in line):
                # a preemptee re-enters the line: never sheddable
                line.append(types.SimpleNamespace(
                    seq_id=back, priority=0, t_submit=now, deadline_s=0.5))
        bus.observe("itl_s", float(rng.uniform(0.0, 0.1)))
        out.append(("allowance", pol.prefill_allowance(
            int(rng.integers(0, 9)), int(rng.integers(0, 3)))))
    out.append(("shed_count", pol.shed_count))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_policy_plans_equal_the_reference(seed):
    got = _plan_trace(tpolicy, TBus, seed)
    assert got == _plan_trace(jpolicy, JBus, seed)
    assert any(shed for entry in got if len(entry) == 3
               for shed in [entry[1]])


def test_policy_config_validation_matches_the_reference():
    for kw in (dict(age_iters=0), dict(max_in_system=0),
               dict(max_queue=-1)):
        with pytest.raises(ValueError):
            tpolicy.PolicyConfig(**kw)
        with pytest.raises(ValueError):
            jpolicy.PolicyConfig(**kw)


# --------------------------------------------------------------------------
# the engine behind a policy
# --------------------------------------------------------------------------
def _drive_slo(eng, request_cls, schedule, max_iters=8000):
    """(arrival, prompt, max_new, priority, deadline_s) schedules; returns
    the completed requests' streams (shed requests land on ``eng.shed``)."""
    pending = sorted(enumerate(schedule), key=lambda t: (t[1][0], t[0]))
    done, it = [], 0
    while True:
        while pending and pending[0][1][0] <= it:
            sid, (_, prompt, max_new, pri, dl) = pending.pop(0)
            assert eng.submit(request_cls(seq_id=sid, prompt=prompt.copy(),
                                          max_new=max_new, priority=pri,
                                          deadline_s=dl))
        if not pending and eng.idle:
            return {r.seq_id: list(r.tokens_out) for r in done}
        done.extend(eng.step())
        it += 1
        assert it <= max_iters, "the scheduler did not drain the workload"


def _clamp(raw, seed, vocab, n_pages, pt=8, max_seq=64):
    """The reference's ``_schedule_from`` over 5-tuples: shapes clamped to
    be admissible, prompts drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for arrival, L, max_new, pri, dl in raw:
        worst = -(-min(L + max(max_new, 1), max_seq) // pt)
        if worst > min(n_pages, max_seq // pt) or L >= max_seq:
            L, max_new = min(L, pt), 1
        out.append((arrival, rng.integers(0, vocab, L).astype(np.int32),
                    max_new, pri, dl))
    return out


def _case(name, vocab):
    """name -> (schedule, engine kwargs, cache kwargs, policy kwargs)."""
    if name.startswith("streams"):
        rng = np.random.default_rng(int(name[-1]))
        n_slots = int(rng.integers(2, 5))
        n_pages = int(rng.integers(6, 17))
        raw = [(int(rng.integers(0, 9)), int(rng.integers(1, 21)),
                int(rng.integers(1, 7)), int(rng.integers(0, 3)),
                1e6 if rng.random() < 0.5 else None)
               for _ in range(int(rng.integers(3, 6)))]
        squeeze = name.startswith("streams_squeeze")
        return (_clamp(raw, int(rng.integers(0, 4)), vocab, n_pages),
                dict(n_slots=n_slots,
                     token_budget=n_slots + int(rng.integers(1, 15))),
                dict(page_tokens=8, n_pages=n_pages),
                dict(age_iters=int(rng.integers(1, 7)),
                     itl_target_s=1e-12 if squeeze else None))
    if name.startswith("priority"):
        rng = np.random.default_rng(int(name[-1]))
        pris = rng.integers(0, 4, int(rng.integers(3, 7)))
        n_slots = int(rng.integers(2, 4))
        return ([(0, rng.integers(0, vocab, 4).astype(np.int32), 2, int(p),
                  None) for p in pris],
                dict(n_slots=n_slots, token_budget=n_slots + 6),
                dict(page_tokens=8, n_pages=16), dict(age_iters=10_000))
    # "aging<gap><age_iters>": one class-0 request, then a stream of
    # higher-class arrivals, two slots
    gap, age = int(name[-2]), int(name[-1])
    rng = np.random.default_rng(gap + 10 * age)
    sched = [(0, rng.integers(0, vocab, 4).astype(np.int32), 3, 0, None)]
    sched += [(max(0, i - 2), rng.integers(0, vocab, 4).astype(np.int32), 3,
               gap, None) for i in range(15)]
    return (sched, dict(n_slots=2, token_budget=8),
            dict(page_tokens=8, n_pages=16), dict(age_iters=age))


POLICY_CASES = ("streams0", "streams1", "streams_squeeze4",
                "streams_squeeze3", "priority0", "priority1", "aging11",
                "aging32")


@functools.lru_cache(maxsize=None)
def _jax_policy_run(name, with_policy=True, age=None):
    cfg, tree = _weights()
    sched, ekw, ckw, pkw = _case(name, cfg.vocab)
    if age is not None:
        pkw = dict(pkw, age_iters=age)
    eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  config=JEngineConfig(
                      max_seq=64, chunked=True,
                      cache=JCacheConfig(paged=True, **ckw),
                      policy=jpolicy.PolicyConfig(**pkw)
                      if with_policy else None, **ekw))
    streams = _drive_slo(eng, JRequest, sched)
    return (streams, list(eng.stats["admission_order"]),
            {k: eng.stats[k] for k in COUNTERS},
            [(r.seq_id, r.verdict.code) for r in eng.shed])


def _port_engine(ekw, ckw, policy=None, **extra):
    tcfg = tconfigs.get_smoke_config("qwen2-0.5b",
                                     compute_dtype=torch.float32)
    return tengine.Engine(
        tcfg, params_from_numpy(_weights()[1], tcfg), device="cpu",
        config=tengine.EngineConfig(
            max_seq=64, chunked=True, cache=tcache.CacheConfig(**ckw),
            policy=policy, **ekw, **extra))


@pytest.mark.parametrize("name", POLICY_CASES)
def test_policy_engine_matches_jax_engine(name):
    """Streams, admission order and counters equal the JAX chunked engine's
    behind the same policy. Streams and budget: the policy-free port
    streams the same tokens and the budget holds (also under the ITL
    squeeze). Priority: admissions in non-increasing class. Aging: the
    class-0 request is overtaken a bounded number of times, and admitted
    last with aging off."""
    cfg = _weights()[0]
    sched, ekw, ckw, pkw = _case(name, cfg.vocab)
    eng = _port_engine(ekw, ckw, tpolicy.PolicyConfig(**pkw))
    got = _drive_slo(eng, tengine.Request, sched)
    streams, order, counters, shed = _jax_policy_run(name)
    assert got == streams
    assert eng.stats["admission_order"] == order
    assert {k: eng.stats[k] for k in COUNTERS} == counters
    assert not eng.shed and not shed and set(got) == set(range(len(sched)))
    s = eng.stats_summary()
    assert s["max_iter_tokens"] <= s["token_budget"]
    assert eng.pool.alloc.free_pages == eng.pool.alloc.n_pages
    eng.pool.alloc.audit()
    if name.startswith("streams"):
        free = _port_engine(ekw, ckw)
        assert _drive_slo(free, tengine.Request, sched) == got
        if "squeeze" in name:
            assert eng.metrics_snapshot()["counters"].get(
                "itl_budget_squeezes", 0) > 0
    elif name.startswith("priority"):
        pris = [sched[i][3] for i in order]
        assert pris == sorted(pris, reverse=True)
    else:
        gap, age = int(name[-2]), int(name[-1])
        assert order.index(0) <= min(2 * (age * gap + 2), 14)
        off = _port_engine(ekw, ckw, tpolicy.PolicyConfig(age_iters=10_000))
        _drive_slo(off, tengine.Request, sched)
        assert off.stats["admission_order"].index(0) == 15
        assert off.stats["admission_order"] == \
            _jax_policy_run(name, age=10_000)[1]


# --------------------------------------------------------------------------
# the chunked shedding mix over a tiered stack
# --------------------------------------------------------------------------
N_REQ, HOT_PAGES, PT = 12, 4, 8


def _shedding_mix(vocab):
    """The reference's tiered oversubscription replay: 12 six-token
    requests, every third one interactive (class 1), the last two class-0
    requests with a deadline that lapses before the first pass."""
    rng = np.random.default_rng(0)
    pris = [1 if i % 3 == 0 else 0 for i in range(N_REQ)]
    deadlines = [None] * N_REQ
    for i in [i for i in range(N_REQ) if pris[i] == 0][-2:]:
        deadlines[i] = 1e-6
    return [(0, rng.integers(0, vocab, 6).astype(np.int32), 6, pris[i],
             deadlines[i]) for i in range(N_REQ)]


def _shedding_kwargs(cfg, with_policy, overlap, mod):
    return (dict(n_slots=2, token_budget=6, overlap=overlap),
            dict(tiered=True, page_tokens=PT, n_pages=HOT_PAGES,
                 host_budget_bytes=16 * 2 * N_REQ * token_bytes(cfg) * PT),
            mod.PolicyConfig(max_in_system=2, max_queue=4)
            if with_policy else None)


@functools.lru_cache(maxsize=None)
def _jax_shedding_run(with_policy, overlap):
    cfg, tree = _weights()
    ekw, ckw, pol = _shedding_kwargs(cfg, with_policy, overlap, jpolicy)
    eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  config=JEngineConfig(
                      max_seq=64, chunked=True, policy=pol,
                      cache=JCacheConfig(paged=True, **ckw), **ekw))
    streams = _drive_slo(eng, JRequest, _shedding_mix(cfg.vocab))
    return (streams, {k: eng.stats[k] for k in COUNTERS},
            [(r.seq_id, r.verdict.code) for r in eng.shed])


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_chunked_shedding_mix_matches_jax(overlap):
    cfg = _weights()[0]
    sched = _shedding_mix(cfg.vocab)
    # without the policy: everything admits by preempting, and the pool
    # refuses over and over while the population rotates
    ekw, ckw, _ = _shedding_kwargs(cfg, False, overlap, tpolicy)
    base = _port_engine(ekw, ckw)
    base_streams = _drive_slo(base, tengine.Request, sched)
    j_streams, j_counters, _ = _jax_shedding_run(False, overlap)
    assert base_streams == j_streams
    assert {k: base.stats[k] for k in COUNTERS} == j_counters
    assert base.stats["admission_refusals"] >= N_REQ
    assert base.stats["preemptions"] > 0
    if overlap:
        assert (j_counters["admission_refusals"],
                j_counters["preemptions"]) == (70, 72)
    # behind the policy: shed before the pool ever refuses
    ekw, ckw, pol = _shedding_kwargs(cfg, True, overlap, tpolicy)
    eng = _port_engine(ekw, ckw, pol)
    got = _drive_slo(eng, tengine.Request, sched)
    p_streams, p_counters, p_shed = _jax_shedding_run(True, overlap)
    shed = [(r.seq_id, r.verdict.code) for r in eng.shed]
    assert shed == p_shed
    assert shed == [(10, "deadline"), (11, "deadline"), (8, "overload"),
                    (7, "overload"), (5, "overload"), (4, "overload")]
    assert got == p_streams
    assert {k: eng.stats[k] for k in COUNTERS} == p_counters
    assert eng.stats["admission_refusals"] == 0
    assert eng.stats["shed"] == len(shed) and len(shed) + len(got) == N_REQ
    assert all(r.verdict.reason for r in eng.shed)
    assert all(i in got for i in range(N_REQ) if sched[i][3] == 1)
    for sid, toks in got.items():
        assert toks == base_streams[sid]      # admitted streams unchanged
    pool = eng.pool
    pool.alloc.audit()
    assert pool.alloc.free_pages == HOT_PAGES and not pool.cold_seqs()
    assert pool.hero.levels[3].in_use() == 0 and eng.idle
    assert eng.metrics_snapshot()["counters"]["shed_requests"] == len(shed)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def test_serve_cli_tier_and_policy_flags_on_the_cpu(capsys):
    from repro_torch.launch import serve
    common = ["--device", "cpu", "--chunked-prefill", "--tiered",
              "--pages", "6", "--page-tokens", "8", "--requests", "6", "--slots", "2",
              "--max-seq", "32", "--max-new", "3", "--token-budget", "6",
              "--prompt-len", "8", "--prompt-len-max", "20"]
    serve.main(common + ["--priorities", "2", "--max-in-system", "2",
                         "--max-queue", "2"])
    out = capsys.readouterr().out
    assert "[serve:chunked+tiered] " in out
    slo = [ln for ln in out.splitlines() if ln.startswith("[serve:slo]")]
    assert len(slo) == 1 and slo[0].startswith("[serve:slo] shed ")
    assert "[serve:tiered] preemptions " in out
    serve.main(common + ["--kv-dtype", "int8", "--host-budget-mb", "1"])
    out = capsys.readouterr().out
    tier = [ln for ln in out.splitlines() if ln.startswith("[serve:tiered]")]
    assert "[serve:int8+chunked+tiered] 6 requests, 18 tokens" in out
    n = int(tier[0].split("preemptions ")[1].split(",")[0])
    assert n > 0 and "[serve:slo]" not in out
