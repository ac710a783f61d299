"""One clock for the tp ranks: an ITL target and deadlines under tp > 1.

The reference is one controller with one clock, so it serves an ITL
target (the policy's budget squeeze reads the ITL p99 of the clock's
readings) and requests' deadlines under tp. The port runs one scheduler a
rank; every read of ``Tracer.now()`` there is rank 0's reading, broadcast
by the executor over a gloo group (serve/executor.py ``read_clock``).

The case: qwen2-0.5b's f32 smoke config on the chunked stack at tp = 2
over gloo, behind ``PolicyConfig(itl_target_s=ITL_TARGET)``, ten requests
arriving over twelve iterations with a mix of deadlines. The clock is a
manual one (parallel/tp_jobs.py ``ManualClock``) that the driver sets once
an iteration to ``TICKS``, whose steps grow, so the ITL p99 crosses the
target mid-run; rank 1's clock is skewed (``SKEW``: 7x + 100 s). Both
ranks' streams, admission order, shed ``(seq_id, code)`` list and counters
equal the JAX chunked engine's at tp = 1 under rank 0's clock and the
port's own at tp = 1, with squeezes in some but not all iterations with a
mid-prefill resident, deadlines both lapsed and met; as a control, the
port at tp = 1 under rank 1's skewed clock sheds otherwise. Besides: the
CLI's ``--tp 2 --itl-target-ms``, and a read one rank makes alone failing
the call within the group's wait (the rank check naming a rank whose
clock reads drifted: tests/test_torch_tp.py).
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.policy import PolicyConfig as JPolicyConfig
from repro_torch.models import convert
from repro_torch.parallel import launch
from repro_torch.parallel.tp_jobs import (ManualClock, ServeJob, drive,
                                          replicated, serve_schedule)
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.policy import PolicyConfig as TPolicyConfig

from test_torch_tp import COUNTERS, TIMEOUT_S, _tcfg, _weights

ENGINE = dict(n_slots=2, max_seq=64, chunked=True, token_budget=8)
CACHE = dict(page_tokens=8, n_pages=16)
ITL_TARGET = 0.025
SKEW = (7.0, 100.0)
DEADLINES = (None, 0.03, 0.15, 1.0)
TICKS = tuple(float(t) for t in np.cumsum(
    [0.0] + [0.01 * 1.06 ** i for i in range(399)]))


def _schedule(vocab):
    """Ten requests arriving over iterations 0-11, prompts of 4-17
    tokens, 2-5 new tokens, deadlines cycling through ``DEADLINES``."""
    rng = np.random.default_rng(1)
    return [(int(rng.integers(0, 12)),
             rng.integers(0, vocab, int(rng.integers(4, 18))).astype(
                 np.int32), int(rng.integers(2, 6)), 0, DEADLINES[i % 4])
            for i in range(10)]


def _jax_drive(eng, sched, clock):
    """tp_jobs.drive's order for the JAX engine: the clock set to the
    iteration's tick, then the iteration's arrivals, then a step."""
    pending = sorted(enumerate(sched), key=lambda t: (t[1][0], t[0]))
    done, it = [], 0
    while True:
        clock.set(TICKS[min(it, len(TICKS) - 1)])
        while pending and pending[0][1][0] <= it:
            sid, (_, prompt, max_new, pri, dl) = pending.pop(0)
            assert eng.submit(JRequest(seq_id=sid, prompt=prompt.copy(),
                                       max_new=max_new, priority=pri,
                                       deadline_s=dl))
        if not pending and eng.idle:
            return {r.seq_id: list(r.tokens_out) for r in done}
        done.extend(eng.step())
        it += 1
        assert it <= 4000


def _summary(streams, stats, shed, bus):
    return dict(streams=streams,
                admission_order=list(stats["admission_order"]),
                shed=[(int(r.seq_id), r.verdict.code) for r in shed],
                counters={k: stats.get(k, 0) for k in COUNTERS + ("shed",)},
                squeezes=bus.get("itl_budget_squeezes", 0),
                mids=sum(1 for e in stats["iter_log"] if e["mid_prefill"]))


@functools.lru_cache(maxsize=None)
def _jax_tp1():
    """The JAX chunked engine at tp = 1 under rank 0's clock."""
    cfg, tree = _weights(2)
    clock = ManualClock()
    eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  config=JEngineConfig(
                      **ENGINE, clock=clock,
                      policy=JPolicyConfig(itl_target_s=ITL_TARGET),
                      cache=JCacheConfig(paged=True, **CACHE)))
    streams = _jax_drive(eng, _schedule(cfg.vocab), clock)
    return _summary(streams, eng.stats, eng.shed,
                    eng.metrics_snapshot()["counters"])


def _config(tp, **kw):
    return TEngineConfig(**ENGINE, tp=tp,
                         policy=TPolicyConfig(itl_target_s=ITL_TARGET),
                         cache=TCacheConfig(**CACHE), **kw)


def _job(tp, clocks):
    cfg, tree = _weights(2)
    return ServeJob(cfg=_tcfg(2), weights=tree, schedule=_schedule(cfg.vocab),
                    config=_config(tp, check_ranks=tp > 1), clocks=clocks,
                    ticks=TICKS)


def _port_tp1(scale=1.0, offset=0.0):
    """The port at tp = 1, in this process, under ``scale * t + offset``."""
    clock = ManualClock(scale, offset)
    job = _job(1, None)
    eng = TEngine(job.cfg, convert.params_from_numpy(job.weights, job.cfg),
                  device="cpu", config=_config(1, clock=clock))
    done = drive(eng, job, clock)
    return _summary({r.seq_id: list(r.tokens_out) for r in done},
                    eng.stats, eng.shed, eng.metrics_snapshot()["counters"])


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """Each rank's result at tp = 2, rank 1's clock skewed."""
    out = launch.spawn(serve_schedule, 2, (_job(2, (ManualClock(),
                                                    ManualClock(*SKEW))),),
                       store_dir=str(tmp_path_factory.mktemp("tp_clock")),
                       backend="gloo", timeout_s=TIMEOUT_S)
    replicated(out, ("streams", "stats", "admission_order", "shed",
                     "bus_counters", "iter_log", "executor", "pool"))
    return out


def test_tp2_under_one_clock_equals_jax_tp1(tp2):
    want = _jax_tp1()
    assert _port_tp1() == want
    sched = _schedule(_weights(2)[0].vocab)
    for r in tp2:
        got = dict(streams=r["streams"],
                   admission_order=r["admission_order"], shed=r["shed"],
                   counters={k: r["stats"].get(k, 0)
                             for k in COUNTERS + ("shed",)},
                   squeezes=r["bus_counters"].get("itl_budget_squeezes", 0),
                   mids=sum(1 for e in r["iter_log"] if e["mid_prefill"]))
        assert got == want, f"rank {r['rank']}"
        ex = r["executor"]
        assert ex["rank_checks"] > 0 and ex["clock_reads"] > 0
    assert 0 < want["squeezes"] < want["mids"]
    assert any(code == "deadline" for _, code in want["shed"])
    assert any(sched[s][4] is not None for s in want["admission_order"])
    assert len(want["shed"]) + len(want["streams"]) == len(sched)
    # the reads: one a submission, an admission, an emitted token and a
    # policy pass over a non-empty mailbox (equal on both ranks)
    c = want["counters"]
    assert tp2[0]["executor"]["clock_reads"] >= \
        len(sched) + len(want["admission_order"]) + c["decode_tokens"]


def test_tp1_under_the_skewed_clock_sheds_otherwise():
    """The control: rank 1's clock, were it read, would decide otherwise,
    so the tp = 2 case above reads rank 0's alone."""
    want = _jax_tp1()
    skewed = _port_tp1(*SKEW)
    assert skewed["shed"] != want["shed"]
    assert skewed["squeezes"] != want["squeezes"]


def test_the_clock_driven_policy_under_tp_is_taken():
    pol = TPolicyConfig(itl_target_s=0.05)
    conf = TEngineConfig(tp=2, policy=pol).normalized()
    assert conf.policy == pol and conf.cache.paged


def test_serve_cli_tp_with_an_itl_target(capfd):
    """``--tp 2 --itl-target-ms`` serves on two gloo ranks; rank 0 prints
    its ``[serve:slo]`` line and how often the clock was broadcast."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--tp", "2", "--chunked-prefill",
                "--requests", "4", "--slots", "2", "--max-seq", "32",
                "--max-new", "3", "--page-tokens", "8", "--token-budget",
                "6", "--itl-target-ms", "1"])
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve:")]
    assert lines[0].startswith("[serve:tp2+chunked] 4 requests, 12 tokens")
    assert sum(ln.startswith("[serve:slo] shed 0") for ln in lines) == 1, out
    clock = [ln for ln in lines if "reads of rank 0's clock" in ln]
    assert len(clock) == 1 and " an iteration)" in clock[0], out


def _lonely_read(rank, cfg, tree):
    """Rank 0 reads the shared clock; rank 1 never joins the broadcast."""
    eng = TEngine(cfg, convert.params_from_numpy(tree, cfg), device="cpu",
                  config=TEngineConfig(
                      n_slots=2, max_seq=32, tp=2,
                      cache=TCacheConfig(page_tokens=8, n_pages=8)))
    if rank == 0:
        eng.tracer.now()
    return rank


def test_a_clock_read_on_one_rank_fails_the_call(tmp_path):
    """A clock read that only one rank makes fails the spawn within its
    bounded wait (the ``test_a_rank_stuck_in_a_collective_fails_the_call``
    pattern); no process is left behind."""
    t0 = time.monotonic()
    with pytest.raises(Exception):
        launch.spawn(_lonely_read, 2, (_tcfg(2), _weights(2)[1]),
                     store_dir=str(tmp_path), backend="gloo", timeout_s=15.0)
    assert time.monotonic() - t0 < 40.0
