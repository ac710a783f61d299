"""granite-moe-3b-a800m through the port's engines against the JAX engines.

At the reference's f32 smoke config (2 layers, 8 experts, top-2) with its
``PRNGKey(0)`` weights carried across by ``models/convert.py``, each
engine and stack gives the JAX engine's greedy streams and scheduling
counters on the same schedule:

  * chunked, with a token budget that splits prompts into chunks whose
    capacity binds (an expert selects fewer tokens than routed to it);
  * monolithic paged;
  * dense, on equal-length prompts at 2 slots: the reference's dense
    prefill runs every slot's row (the others token 0) and those rows
    compete for expert capacity, so the port runs them too (a one-row
    prefill gives other streams, pinned below);
  * int8 + prefix (chunked), on a shared-prefix mix;
  * tiered (chunked), long prompts through a small budget and hot tier.

Under capacity dispatch a chunk's size decides its drops, so each stack is
held against JAX's same stack, never against another stack.
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
from repro.serve.cache import CacheConfig as JCacheConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.kvcache import token_bytes as jtoken_bytes
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.cache import CacheConfig as TCacheConfig
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import EngineConfig as TEngineConfig
from repro_torch.serve.engine import Request as TRequest

ARCH = "granite-moe-3b-a800m"
COUNTERS = ("decode_steps", "decode_tokens", "prefills", "prefill_chunks",
            "prefill_chunk_tokens", "admission_refusals", "token_fetches",
            "tokens_fetched", "prefix_hits", "prefix_full_hits",
            "prefix_shared_tokens", "cow_forks", "preemptions",
            "preempted_mid_prefill", "swap_out_count", "swap_in_count",
            "swap_out_bytes", "swap_in_bytes")


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = jconfigs.get_smoke_config(ARCH, compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    tcfg = tconfigs.get_smoke_config(ARCH, compute_dtype=torch.float32)
    return cfg, params, jax.tree_util.tree_map(np.array, params), tcfg


def _model():
    _, _, tree, tcfg = _weights()
    return params_from_numpy(tree, tcfg)


def _mix(seed, lens, max_new=5):
    """Every request at iteration 0."""
    vocab = _weights()[0].vocab
    rng = np.random.default_rng(seed)
    return [(0, rng.integers(0, vocab, n).astype(np.int32), max_new)
            for n in lens]


def _shared_mix():
    """A 12-token system prompt and suffixes of 3-6 tokens, two
    iterations apart (tests/test_torch_tp.py's prefix mix)."""
    vocab = _weights()[0].vocab
    rng = np.random.default_rng(17)
    shared = rng.integers(0, vocab, 12)
    return [(2 * i, np.concatenate([shared, rng.integers(
        0, vocab, 3 + i)]).astype(np.int32), 3) for i in range(4)]


def _midprefill_mix():
    """Long prompts behind a shared head, arriving over 4 iterations
    (tests/test_torch_tiering.py's "midprefill" mix)."""
    vocab = _weights()[0].vocab
    rng = np.random.default_rng(1)
    head = rng.integers(0, vocab, 10)
    lens, arrivals = rng.integers(14, 31, 4), sorted(rng.integers(0, 4, 4))
    return [(int(a), np.concatenate([head, rng.integers(
        0, vocab, int(n) - 10)]).astype(np.int32), int(m))
        for a, n, m in zip(arrivals, lens, rng.integers(2, 5, 4))]


def _stack(name):
    """(schedule, engine kwargs, cache kwargs) of each stack."""
    chunked = dict(n_slots=2, max_seq=64, chunked=True)
    if name == "chunked":
        return (_mix(11, (20, 27, 5, 24)), dict(chunked, token_budget=24),
                dict(paged=True, page_tokens=8))
    if name == "monolithic":
        return (_mix(11, (3, 9, 5, 12)), dict(n_slots=2, max_seq=64),
                dict(paged=True, page_tokens=8))
    if name == "dense":
        return _mix(11, (6, 6, 6, 6)), dict(n_slots=2, max_seq=64), {}
    if name == "int8+prefix":
        return (_shared_mix(), dict(chunked, token_budget=6),
                dict(paged=True, page_tokens=8, n_pages=16, prefix=True,
                     prefix_pages=8, kv_dtype="int8"))
    if name == "tiered":
        sched = _midprefill_mix()
        budget = 16 * 2 * len(sched) * jtoken_bytes(_weights()[0]) * 8
        return (sched, dict(chunked, token_budget=6),
                dict(paged=True, page_tokens=8, n_pages=8, tiered=True,
                     host_budget_bytes=budget))
    raise KeyError(name)


def _drive(eng, request_cls, schedule, max_iters=2000):
    """Each request at its arrival iteration; step until idle."""
    pending = sorted(enumerate(schedule), key=lambda t: (t[1][0], t[0]))
    done, it = [], 0
    while True:
        while pending and pending[0][1][0] <= it:
            sid, (_, prompt, max_new) = pending.pop(0)
            assert eng.submit(request_cls(seq_id=sid, prompt=prompt.copy(),
                                          max_new=max_new))
        if not pending and eng.idle:
            break
        done.extend(eng.step())
        it += 1
        assert it <= max_iters
    assert len(done) == len(schedule)
    stats = eng.stats
    return ({int(r.seq_id): list(r.tokens_out) for r in done},
            {k: int(stats.get(k, 0)) for k in COUNTERS})


@functools.lru_cache(maxsize=None)
def _jax(name):
    cfg, params, _, _ = _weights()
    sched, ekw, ckw = _stack(name)
    return _drive(JEngine(cfg, params, config=JEngineConfig(
        cache=JCacheConfig(**ckw), **ekw)), JRequest, sched)


def _port(name):
    sched, ekw, ckw = _stack(name)
    eng = TEngine(_weights()[3], _model(), device="cpu",
                  config=TEngineConfig(cache=TCacheConfig(**ckw), **ekw))
    return eng, _drive(eng, TRequest, sched)


@pytest.fixture
def moe_calls(monkeypatch):
    """Record (tokens routed, assignments dropped) of every MoE call."""
    calls = []
    inner = tmoe.dispatch_compute

    def recording(xf, router_w, w_gate, w_up, w_down, cfg):
        gates, idx, _ = tmoe.route(router_w, xf, cfg)
        sel = tmoe.select(gates, idx, cfg)
        calls.append((xf.shape[0],
                      int(tmoe.dropped(idx, *sel[1:], cfg.n_experts))))
        return inner(xf, router_w, w_gate, w_up, w_down, cfg)

    monkeypatch.setattr(tmoe, "dispatch_compute", recording)
    return calls


@pytest.mark.parametrize("stack", ["chunked", "monolithic", "dense",
                                   "int8+prefix", "tiered"])
def test_engine_matches_jax_engine(stack, moe_calls):
    eng, got = _port(stack)
    ref = _jax(stack)
    assert got == ref
    streams, count = got
    assert eng.config.chunked == (stack not in ("monolithic", "dense"))
    assert eng.config.cache.paged == (stack != "dense")
    if eng.config.cache.paged:
        pool = eng.pool
        if pool.prefix is not None:
            assert count["prefix_hits"] > 0
            pool.prefix.clear()
        assert pool.alloc.free_pages == pool.alloc.n_pages
        pool.alloc.audit()
    if stack == "tiered":
        assert count["preemptions"] > 0
        assert count["swap_out_bytes"] == count["swap_in_bytes"]
    B = eng.config.n_slots
    if stack == "chunked":
        # prompts split, and a chunk's capacity binds
        assert count["prefill_chunks"] > len(streams)
        assert any(n > B and drops > 0 for n, drops in moe_calls)
    # a decode step routes every slot's row, a dense prefill every slot's
    # L rows (the others token 0): the reference's token counts
    n_layers = _weights()[3].n_layers()
    decode_calls = [n for n, _ in moe_calls if n == B]
    assert len(decode_calls) >= n_layers * count["decode_steps"]
    if stack == "dense":
        assert all(n % B == 0 for n, _ in moe_calls)


def test_dense_prefill_of_one_row_gives_other_streams(monkeypatch):
    """Pinned: the dense engine's padding rows take part in a MoE's
    capacity. Treating rows as independent (the one-row prefill, right for
    dense MLPs) gives other streams than the JAX dense engine's."""
    monkeypatch.setattr(ttransformer, "couples_rows", lambda cfg: False)
    assert _port("dense")[1][0] != _jax("dense")[0]


def test_decode_routes_inactive_rows_as_the_reference(moe_calls):
    """A paged decode step routes all B rows, a free slot's row as token 0
    with zero attention: 4 slots with one request decode [4, 1] rows."""
    sched = _mix(3, (5,), max_new=4)
    eng = TEngine(_weights()[3], _model(), device="cpu", config=TEngineConfig(
        n_slots=4, max_seq=64, chunked=True, token_budget=8,
        cache=TCacheConfig(paged=True, page_tokens=8)))
    streams, count = _drive(eng, TRequest, sched)
    cfg, params, _, _ = _weights()
    ref = _drive(JEngine(cfg, params, config=JEngineConfig(
        n_slots=4, max_seq=64, chunked=True, token_budget=8,
        cache=JCacheConfig(paged=True, page_tokens=8))), JRequest, sched)
    assert (streams, count) == ref
    assert [n for n, _ in moe_calls].count(4) == 2 * count["decode_steps"]


def test_serve_cli_granite_on_the_cpu(capfd):
    """``--arch granite-moe-3b-a800m`` on the chunked, monolithic and dense
    engines serves every request."""
    from repro_torch.launch import serve
    for extra, mode in ((["--chunked-prefill", "--token-budget", "6"],
                         "chunked"), (["--paged"], "paged"), ([], "dense")):
        serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                    "--slots", "2", "--max-seq", "32", "--max-new", "3",
                    "--page-tokens", "8", *extra])
        out = capfd.readouterr().out
        assert f"[serve:{mode}] 3 requests, 9 tokens" in out, out
