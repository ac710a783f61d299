"""The port's tensor parallelism against the JAX engine at tp = 1.

The reference's tp tests (tests/test_scheduler_properties.py:406-470,
:844, :919) hold its tp = N streams bit-identical to tp = 1; its tp path
raises on the installed JAX (ROADMAP.md §3), so here the port's tp = 2
and tp = 4 engines are held against the JAX engine at tp = 1: the same
greedy streams and scheduling counters, on the chunked, monolithic paged,
int8, prefix and tiered stacks, with tracing, with the overlapped loop and
behind the SLO policy (its clock-driven inputs, an ITL target and
deadlines, under one clock for the ranks: tests/test_torch_tp_clock.py).
The f32 smoke config is the reference's, with its ``n_kv=tp`` override
for tp = 4 (tests/test_scheduler_properties.py:410-420).

The port's ranks are processes: each test spawns them
(parallel/launch.py) over gloo on the CPU, each serving its schedule
through repro_torch/parallel/tp_jobs.py, with the group's store in the test's
own ``tmp_path`` and a bounded wait, so a deadlocked collective fails the
test instead of hanging the suite. Every rank runs with the
rank-consistency check on (its page tables hashed and gathered after
every iteration), and every rank must return the same streams and
counters.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.serve import trace as jtrace
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.executor import Executor as JExecutor
from repro.serve.kvcache import token_bytes as jtoken_bytes
from repro.serve.policy import PolicyConfig as JPolicyConfig
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as ttransformer
from repro_torch.parallel import launch, sharding
from repro_torch.serve import executor as texecutor
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.policy import PolicyConfig as TPolicyConfig
from repro_torch.parallel.tp_jobs import ServeJob, replicated, serve_schedule

COUNTERS = ("prefill_chunks", "prefill_chunk_tokens", "decode_tokens",
            "decode_steps", "admission_refusals", "evictions_reprefill",
            "prefills", "prefix_hits", "prefix_full_hits",
            "prefix_shared_tokens", "cow_forks", "preemptions",
            "preempted_mid_prefill", "swap_out_count", "swap_in_count",
            "swap_out_bytes", "swap_in_bytes")
TIMEOUT_S = 90.0


@functools.lru_cache(maxsize=None)
def _weights(n_kv):
    """The reference's smoke config in f32 (``n_kv`` overridden where tp
    does not divide 2) and its ``PRNGKey(0)`` weights as numpy leaves."""
    cfg = jconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=jnp.float32,
                                    n_kv=n_kv)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    return cfg, jax.tree_util.tree_map(np.array, params)


def _tcfg(n_kv):
    return tconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32,
                                     n_kv=n_kv)


def _random_mix(seed, vocab):
    """tests/test_scheduler_properties.py:437-440's schedule."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 6)),
             rng.integers(0, vocab, int(rng.integers(1, 20))).astype(np.int32),
             int(rng.integers(1, 5))) for _ in range(4)]


def _staggered_mix(seed, vocab, base=3):
    """tests/test_scheduler_properties.py:454-456 (and :925-928, base 3;
    :466-468, base 4): four requests two iterations apart, longer each."""
    rng = np.random.default_rng(seed)
    return [(2 * i, rng.integers(0, vocab, base + 2 * i).astype(np.int32), 3)
            for i in range(4)]


def _shared_mix(vocab):
    """tests/test_torch_tiering.py's prefix + tiering mix: a 12-token
    system prompt, suffixes of 3-6 tokens, two iterations apart."""
    rng = np.random.default_rng(17)
    shared = rng.integers(0, vocab, 12)
    return [(2 * i, np.concatenate([shared, rng.integers(
        0, vocab, 3 + i)]).astype(np.int32), 3) for i in range(4)]


def _host_budget(cfg, n_req, pt=8):
    """tests/test_scheduler_properties.py's tiered host budget."""
    return 16 * 2 * n_req * jtoken_bytes(cfg) * pt


# name -> (schedule(vocab, cfg), engine kwargs, cache kwargs): each stack
# the reference's tp tests cover, at its tests' shapes
def _stack(name, cfg):
    v = cfg.vocab
    chunked = dict(n_slots=2, max_seq=64, chunked=True, token_budget=10)
    if name == "chunked":
        return _random_mix(31, v), chunked, dict(page_tokens=8, n_pages=16)
    if name == "monolithic":
        return (_random_mix(31, v), dict(n_slots=2, max_seq=64),
                dict(paged=True, page_tokens=8, n_pages=16))
    if name == "int8":
        return (_random_mix(31, v), chunked,
                dict(page_tokens=8, n_pages=16, kv_dtype="int8"))
    if name == "prefix":
        return (_shared_mix(v), dict(chunked, token_budget=6),
                dict(page_tokens=8, n_pages=16, prefix=True,
                     prefix_pages=8))
    sched = _staggered_mix(13, v)
    tiered = dict(page_tokens=8, n_pages=8, tiered=True,
                  host_budget_bytes=_host_budget(cfg, len(sched)))
    if name == "tiered":
        # tests/test_torch_tiering.py's "midprefill" mix: long prompts
        # through a small budget, residents preempted between chunks
        rng = np.random.default_rng(1)
        head = rng.integers(0, v, 10)
        lens, arrivals = rng.integers(14, 31, 4), sorted(rng.integers(0, 4, 4))
        sched = [(int(a), np.concatenate([head, rng.integers(
            0, v, int(n) - 10)]).astype(np.int32), int(m))
            for a, n, m in zip(arrivals, lens, rng.integers(2, 5, 4))]
        return (sched, dict(chunked, token_budget=6),
                dict(tiered, host_budget_bytes=_host_budget(cfg, 4)))
    if name == "int8+tiered+prefix":
        sched = _shared_mix(v)
        return (sched, dict(chunked, token_budget=6),
                dict(tiered, n_pages=6, prefix=True, prefix_pages=3,
                     kv_dtype="int8",
                     host_budget_bytes=_host_budget(cfg, len(sched))))
    if name == "policy":
        # tests/test_torch_policy.py's shedding mix without its two
        # deadlines: 12 requests at once, every third one in class 1, two
        # in the system and four waiting at most, the rest shed
        rng = np.random.default_rng(0)
        sched = [(0, rng.integers(0, v, 6).astype(np.int32), 6,
                  1 if i % 3 == 0 else 0) for i in range(12)]
        return (sched, dict(chunked, token_budget=6,
                            policy=dict(max_in_system=2, max_queue=4)),
                dict(tiered, n_pages=4,
                     host_budget_bytes=_host_budget(cfg, len(sched))))
    if name in ("traced", "overlap", "sync"):
        # the stall-accounting (:919, base 4 at seed 19) and overlap (:844,
        # base 3 at seed 41) cases, both on the tiered stack
        sched = _staggered_mix(19, v, 4) if name == "traced" else \
            _staggered_mix(41, v)
        return (sched, dict(chunked, overlap=name != "sync",
                            preempt_quantum=1, trace=name == "traced"),
                dict(tiered, host_budget_bytes=_host_budget(cfg, len(sched))))
    raise KeyError(name)


def _jax_drive(eng, schedule, max_iters=4000):
    pending = sorted(enumerate(schedule), key=lambda t: (t[1][0], t[0]))
    done, it = [], 0
    while True:
        while pending and pending[0][1][0] <= it:
            sid, (_, prompt, max_new, *pri) = pending.pop(0)
            assert eng.submit(JRequest(seq_id=sid, prompt=prompt.copy(),
                                       max_new=max_new,
                                       priority=pri[0] if pri else 0))
        if not pending and eng.idle:
            return {r.seq_id: list(r.tokens_out) for r in done}
        done.extend(eng.step())
        it += 1
        assert it <= max_iters


@functools.lru_cache(maxsize=None)
def _jax_tp1(name, n_kv):
    """The JAX engine at tp = 1 on the stack: (streams, counters, shed
    verdicts)."""
    cfg, tree = _weights(n_kv)
    sched, ekw, ckw = _stack(name, cfg)
    ckw = dict(ckw, paged=True)
    pol = ekw.pop("policy", None)
    eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  config=JEngineConfig(
                      cache=JCacheConfig(**ckw), **ekw,
                      policy=JPolicyConfig(**pol) if pol else None))
    streams = _jax_drive(eng, sched)
    return (streams, {k: eng.stats.get(k, 0) for k in COUNTERS},
            [(r.seq_id, r.verdict.code) for r in eng.shed])


def _port_tp(name, tp, n_kv, tmp_path):
    """The port's engine on ``tp`` ranks over gloo: every rank's result,
    checked equal across ranks; returns rank 0's."""
    cfg, tree = _weights(n_kv)
    sched, ekw, ckw = _stack(name, cfg)
    pol = ekw.pop("policy", None)
    job = ServeJob(
        cfg=_tcfg(n_kv), weights=tree, schedule=sched,
        config=TEngineConfig(tp=tp, check_ranks=True,
                             cache=TCacheConfig(**ckw), **ekw,
                             policy=TPolicyConfig(**pol) if pol else None))
    out = launch.spawn(serve_schedule, tp, (job,),
                       store_dir=str(tmp_path), backend="gloo",
                       timeout_s=TIMEOUT_S)
    res = replicated(out, ("streams", "stats", "iter_log", "executor",
                           "pool", "shed"))
    return res, sched


def _check_invariants(res, schedule):
    """tests/test_scheduler_properties.py:77-133 on a rank's drained
    engine: the budget, fair share, bounded wait, token accounting, and
    nothing leaked (the prefix cache's pages aside, then cleared)."""
    budget, log, s = res["token_budget"], res["iter_log"], res["stats"]
    total_prompt = sum(len(p) for _, p, _ in schedule)
    shared = s.get("prefix_shared_tokens", 0)
    streak = {}
    for entry in log:
        assert entry["decode_tokens"] + entry["prefill_tokens"] <= budget
        chunked = {sid for sid, _, _ in entry["chunks"]}
        if entry["mid_prefill"] and \
                budget - entry["decode_tokens"] >= len(entry["mid_prefill"]):
            assert set(entry["mid_prefill"]) <= chunked
        for sid in entry["mid_prefill"]:
            streak[sid] = 0 if sid in chunked else streak.get(sid, 0) + 1
            assert streak[sid] <= total_prompt
    if s["evictions_reprefill"] == 0 and s["preempted_mid_prefill"] == 0:
        assert s["prefill_chunk_tokens"] == total_prompt - shared
    else:
        assert s["prefill_chunk_tokens"] >= total_prompt - shared
    _check_drained(res)


def _check_drained(res):
    pool = res["pool"]
    assert not res["busy"] and not res["in_flight"]
    assert pool["seq_pages"] == {} and pool["reserved"] == {}
    assert all(sid == -1 for sid in pool["seq_ids"])
    assert not pool.get("cold") and not pool.get("host_used") \
        and not pool.get("l3_in_use")
    cached = pool.get("cached", [])
    assert len(cached) == len(set(cached)) == pool.get("held", 0)
    assert all(rc == 1 for rc in pool.get("cached_refcounts", []))
    assert pool["free_pages"] == pool["n_pages"] - len(cached)
    if "free_after_clear" in pool:
        assert pool["free_after_clear"] == pool["n_pages"]


def _check_against_jax(name, tp, n_kv, res):
    streams, counters, shed = _jax_tp1(name, n_kv)
    assert res["streams"] == streams, f"tp={tp} {name}: streams diverged"
    assert {k: res["stats"].get(k, 0) for k in COUNTERS} == counters
    assert res["shed"] == shed
    assert res["pool"]["kv_heads"] == n_kv // tp
    assert res["executor"]["rank_checks"] > 0
    return counters


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_streams_match_jax_tp1(tp, tmp_path):
    """tests/test_scheduler_properties.py:432 on the chunked stack: the
    port at tp = 2 and tp = 4 (``n_kv=4``) against the JAX engine at tp =
    1."""
    n_kv = 2 if tp == 2 else tp
    res, sched = _port_tp("chunked", tp, n_kv, tmp_path)
    _check_against_jax("chunked", tp, n_kv, res)
    assert set(res["streams"]) == set(range(len(sched)))
    _check_invariants(res, sched)


@pytest.mark.parametrize("stack", ["monolithic", "int8", "prefix", "tiered",
                                   "int8+tiered+prefix"])
def test_tp_stacks_match_jax_tp1(stack, tmp_path):
    """Each stack at tp = 2: the monolithic engine's dense prefill lands
    in the rank's kv heads (``write_prefill``), int8 pages carry the
    rank's scale columns, the prefix layer's host state stays equal on
    both ranks, and the swap tier moves each rank's shard (the
    tests/test_scheduler_properties.py:452 case) with whole-page byte
    counts."""
    res, sched = _port_tp(stack, 2, 2, tmp_path)
    counters = _check_against_jax(stack, 2, 2, res)
    assert set(res["streams"]) == set(range(len(sched)))
    if stack == "monolithic":
        assert counters["prefills"] == len(sched)
        _check_drained(res)
        return
    _check_invariants(res, sched)
    if "prefix" in stack:
        assert counters["prefix_hits"] > 0
    if stack == "tiered":
        assert counters["preempted_mid_prefill"] > 0
    if "tiered" in stack:   # whole-page bytes: equal to tp = 1's above
        assert counters["swap_out_bytes"] == counters["swap_in_bytes"]


@functools.lru_cache(maxsize=None)
def _granite():
    """granite-moe-3b-a800m's f32 smoke config and its ``PRNGKey(0)``
    weights as numpy leaves."""
    cfg = jconfigs.get_smoke_config("granite-moe-3b-a800m",
                                    compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    return cfg, jax.tree_util.tree_map(np.array, params)


def test_tp_granite_matches_jax_tp1(tmp_path):
    """granite-moe's smoke config at tp = 2 on the chunked stack, with a
    budget of 16, so chunks reach 13-16 tokens, past an expert's capacity
    of 8: each rank attends its kv head, gathers the heads, and runs the
    MoE replicated on the gathered rows. Its routing is deterministic (stable sorts, a gather combine),
    so both ranks sample the same ids, and they are the JAX engine's at
    tp = 1."""
    cfg, tree = _granite()
    sched = _random_mix(31, cfg.vocab)
    ekw = dict(n_slots=2, max_seq=64, chunked=True, token_budget=16)
    ckw = dict(page_tokens=8, n_pages=16)
    jeng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                   config=JEngineConfig(cache=JCacheConfig(paged=True, **ckw),
                                        **ekw))
    streams = _jax_drive(jeng, sched)
    job = ServeJob(
        cfg=tconfigs.get_smoke_config("granite-moe-3b-a800m",
                                      compute_dtype=torch.float32),
        weights=tree, schedule=sched,
        config=TEngineConfig(tp=2, check_ranks=True,
                             cache=TCacheConfig(**ckw), **ekw))
    out = launch.spawn(serve_schedule, 2, (job,), store_dir=str(tmp_path),
                       backend="gloo", timeout_s=TIMEOUT_S)
    res = replicated(out, ("streams", "stats", "iter_log", "executor",
                           "pool"))
    assert res["streams"] == streams
    assert {k: res["stats"].get(k, 0) for k in COUNTERS} == \
        {k: jeng.stats.get(k, 0) for k in COUNTERS}
    assert res["pool"]["kv_heads"] == 1 and res["executor"]["rank_checks"] > 0
    _check_invariants(res, sched)


def test_stall_accounting_under_tensor_parallel(tmp_path):
    """tests/test_scheduler_properties.py:919 at tp = 2: the traced tiered
    engine's streams equal the JAX engine's, and its stall buckets close
    every iteration."""
    res, sched = _port_tp("traced", 2, 2, tmp_path)
    _check_against_jax("traced", 2, 2, res)
    log = res["stall_log"]
    assert log
    for prev, cur in zip(log, log[1:]):
        assert cur["iter"] > prev["iter"]
    for entry in log:
        b = entry["buckets"]
        assert set(b) == set(jtrace.BUCKETS)
        assert all(v >= 0.0 for v in b.values()) and entry["dur"] >= 0.0
        assert sum(b.values()) == pytest.approx(entry["dur"], rel=1e-9,
                                                abs=1e-12)
    assert all(f"stall_pct_{n}" in res["histograms"] for n in jtrace.BUCKETS)


def test_overlap_streams_bit_identical_tp(tmp_path):
    """tests/test_scheduler_properties.py:844 at tp = 2: the overlapped
    loop over the tiered stack gives the JAX synchronous loop's streams
    (and the JAX overlapped loop's counters); the in-flight machinery
    drains."""
    res, sched = _port_tp("overlap", 2, 2, tmp_path)
    _check_against_jax("overlap", 2, 2, res)
    assert res["streams"] == _jax_tp1("sync", 2)[0]
    _check_invariants(res, sched)


def test_tp_policy_matches_jax_tp1(tmp_path):
    """The SLO policy under tp = 2 on the tiered stack: its admission gate,
    queue cap and priority classes (none of which reads the clock) shed
    the same requests with the same verdicts as the JAX engine at tp = 1,
    and the admitted streams and counters are the JAX engine's."""
    res, sched = _port_tp("policy", 2, 2, tmp_path)
    counters = _check_against_jax("policy", 2, 2, res)
    shed = res["shed"]
    assert shed and {code for _, code in shed} == {"overload"}
    assert len(shed) + len(res["streams"]) == len(sched)
    assert all(i in res["streams"] for i in range(len(sched))
               if sched[i][3] == 1)
    assert counters["admission_refusals"] == 0
    _check_drained(res)


def test_serve_cli_tp_on_the_cpu(capfd):
    """``--tp 2`` spawns two gloo ranks; only rank 0 prints, and the run
    serves every request on the chunked engine."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--tp", "2", "--chunked-prefill",
                "--requests", "4", "--slots", "2", "--max-seq", "32",
                "--max-new", "3", "--page-tokens", "8", "--token-budget",
                "6"])
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve:")]
    assert lines[0].startswith("[serve:tp2+chunked] 4 requests, 12 tokens")
    assert sum(ln.endswith("device cpu") for ln in lines) == 1, out


# --------------------------------------------------------------------------
# guards, the group, and the rank-consistency check
# --------------------------------------------------------------------------
def test_tp_guards_match_the_reference():
    """tp must divide n_kv, and the dense engine refuses tp, in the
    reference's words; tp implies a page pool in both packages; tp > 1
    needs a process group of tp ranks."""
    jcfg, tree = _weights(2)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tcfg = _tcfg(2)
    model = ttransformer.init_model(tcfg, torch.Generator().manual_seed(0))
    for kw in (dict(paged=False, tp=2), dict(paged=True, tp=4)):
        with pytest.raises(ValueError) as jerr:
            JExecutor(jcfg, jparams, **kw)
        with pytest.raises(ValueError) as terr:
            texecutor.Executor(tcfg, model, **kw)
        assert str(terr.value) == str(jerr.value)
    assert "divide the kv-head count" in str(terr.value)
    for tp in (2, 4):
        assert JEngineConfig(tp=tp).paged
        assert JEngineConfig(tp=tp).normalized().cache.paged
        assert TEngineConfig(tp=tp).normalized().cache.paged
    assert not JEngineConfig().paged
    assert not TEngineConfig().normalized().cache.paged
    assert sharding.tp_group(1) is None
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        sharding.tp_group(2)
    with pytest.raises(RuntimeError, match="process group"):
        TEngine(tcfg, model, config=TEngineConfig(tp=2), device="cpu")
    with pytest.raises(ValueError, match="tp must be >= 1"):
        sharding.tp_group(0)


def test_int8_pages_imply_a_pool_in_the_port_only():
    """A known difference, pinned (ROADMAP.md §3): the port's
    ``normalized()`` gives int8 pages a page pool, the reference's does
    not, and its engine then serves from the dense compute-dtype pool,
    which ignores int8. Both CLIs imply paged for int8."""
    jconf = JEngineConfig(cache=JCacheConfig(kv_dtype="int8"))
    assert not jconf.paged and not jconf.normalized().cache.paged
    jcfg, tree = _weights(2)
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                   config=jconf)
    assert type(jeng.pool).__name__ == "CachePool"
    tconf = TEngineConfig(cache=TCacheConfig(kv_dtype="int8"))
    assert tconf.normalized().cache.paged
    teng = TEngine(_tcfg(2), ttransformer.init_model(
        _tcfg(2), torch.Generator().manual_seed(0)), config=tconf,
        device="cpu")
    assert teng.pool.quantized and not teng.config.chunked


def _diverging_rank(rank, cfg, tree):
    """Serve two requests with the check on; then rank 1 counts one clock
    read more than rank 0, and after that is undone takes a page alone:
    each time the next check must raise on both ranks."""
    from repro_torch.models import convert
    from repro_torch.serve.engine import Request
    eng = TEngine(cfg, convert.params_from_numpy(tree, cfg), device="cpu",
                  config=TEngineConfig(
                      n_slots=2, max_seq=32, chunked=True, token_budget=8,
                      tp=2, check_ranks=True,
                      cache=TCacheConfig(page_tokens=8, n_pages=8)))
    for i in range(2):
        eng.submit(Request(seq_id=i, prompt=np.arange(5 + i, dtype=np.int32),
                           max_new=2))
    eng.run(max_steps=50)
    stats = eng.executor.stats
    checks, reads = stats["rank_checks"], stats["clock_reads"]
    assert checks > 0 and reads > 0
    errors = []
    for diverge in ("clock", "pages"):
        if rank == 1 and diverge == "clock":
            stats["clock_reads"] += 1
        elif rank == 1:
            eng.pool.admit_prefill(99, 8)
        try:
            eng.executor.check_ranks(eng.pool)
            errors.append(None)
        except RuntimeError as err:
            errors.append(str(err))
        stats["clock_reads"] = reads
    return checks, reads, errors


def test_rank_check_catches_diverged_host_state(tmp_path):
    cfg, tree = _weights(2)
    out = launch.spawn(_diverging_rank, 2, (_tcfg(2), tree),
                       store_dir=str(tmp_path), backend="gloo",
                       timeout_s=TIMEOUT_S)
    (c0, r0, e0), (c1, r1, e1) = out
    assert c0 == c1 > 0 and r0 == r1 > 0
    for err in e0 + e1:
        assert err is not None and "tp ranks diverged" in err


def _lonely_gather(rank):
    """Rank 0 gathers; rank 1 never joins the collective."""
    if rank == 0:
        sharding.all_gather_cat(torch.zeros(1), torch.distributed.group.WORLD,
                                0)
    return rank


def test_a_rank_stuck_in_a_collective_fails_the_call(tmp_path):
    """A collective that a rank never joins fails the spawn within its
    bounded wait; no process is left behind."""
    import time
    t0 = time.monotonic()
    with pytest.raises(Exception):
        launch.spawn(_lonely_gather, 2, store_dir=str(tmp_path),
                     backend="gloo", timeout_s=10.0)
    assert time.monotonic() - t0 < 30.0
