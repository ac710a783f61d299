"""The port's chunked serving engine against the JAX engine, and the
port's boundaries: no JAX inside it, no silent CPU, kernels on the card.

The main-path gate: the same weights and prompts through the JAX chunked
``Engine`` (Pallas in interpret mode) and the port's chunked ``Engine`` on
the CPU, both at the smoke config in f32, give equal greedy streams and
equal scheduling counters, with the overlapped loop on and off, on pages
at the compute dtype and on int8 pages (the port's int8 streams equal the
reference's int8 streams, not its f32 ones).

The engine's reference surface: the keyword form (its feature flags warn,
a keyword beside ``config=`` raises, in the reference's words), the
introspection properties, and ``trace_buffer`` bounding the tracer's ring
as the reference's does (the same retained events, the same drop count;
the CLI's ``--trace-buffer``).
"""
import ast
import functools
import warnings
import os
import pathlib
import subprocess
import sys

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
from repro_torch import configs as tconfigs
from repro_torch.parallel.tp_jobs import ManualClock
from repro_torch.kernels import paged_decode_attention as tpda
from repro_torch.kernels import paged_prefill_attention as tppa
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
COUNTERS = ("prefill_chunks", "prefill_chunk_tokens", "decode_tokens",
            "decode_steps", "admission_refusals", "evictions_reprefill",
            "prefills", "prefix_hits", "prefix_full_hits",
            "prefix_shared_tokens", "cow_forks")

# name -> (prompt lengths, prompt seed, max_new, n_slots, max_seq,
#          page_tokens, n_pages, token_budget)
MIXES = {
    # tests/test_system.py's chunked-prefill mix
    "system": ((6, 13, 3, 9), 4, 5, 3, 64, 8, None, 8),
    "random": (tuple(np.random.default_rng(11).integers(1, 30, 6)), 12, 7,
               3, 64, 8, None, 12),
    # a pool too tight for both prefilled prompts' decode worst case:
    # refusals, and one evict-and-re-prefill to break the promotion deadlock
    "tight": ((8, 8, 5), 5, 12, 2, 32, 4, 6, 16),
}


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = jconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=jnp.float32)
    params = jblocks.split_params(
        jtransformer.init_model(jax.random.PRNGKey(0), cfg))[0]
    tree = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(1)
    for pos in tree["groups"][0]:
        for b in ("bq", "bk", "bv"):
            pos["mixer"][b] = (pos["mixer"][b] + 0.1 * rng.standard_normal(
                pos["mixer"][b].shape)).astype(np.float32)
    return cfg, tree


def _prompts(mix):
    lens, seed = MIXES[mix][:2]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(n)).astype(np.int32) for n in lens]


def _run(eng, request_cls, mix):
    max_new = MIXES[mix][2]
    for i, p in enumerate(_prompts(mix)):
        assert eng.submit(request_cls(seq_id=i, prompt=p.copy(),
                                      max_new=max_new))
    done = eng.run(max_steps=1000)
    return {r.seq_id: list(r.tokens_out) for r in done}


@functools.lru_cache(maxsize=None)
def _jax_run(mix, kv_dtype="compute"):
    cfg, tree = _weights()
    _, _, _, slots, max_seq, pt, pages, budget = MIXES[mix]
    eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  config=JEngineConfig(
                      n_slots=slots, max_seq=max_seq, chunked=True,
                      token_budget=budget,
                      cache=JCacheConfig(paged=True, page_tokens=pt,
                                         n_pages=pages, kv_dtype=kv_dtype)))
    streams = _run(eng, JRequest, mix)
    return streams, {k: eng.stats[k] for k in COUNTERS}


def _port_engine(mix, overlap=True, kv_dtype="compute"):
    _, tree = _weights()
    tcfg = tconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32)
    _, _, _, slots, max_seq, pt, pages, budget = MIXES[mix]
    return tengine.Engine(
        tcfg, params_from_numpy(tree, tcfg), device="cpu",
        config=tengine.EngineConfig(
            n_slots=slots, max_seq=max_seq, chunked=True, token_budget=budget,
            overlap=overlap,
            cache=tcache.CacheConfig(page_tokens=pt, n_pages=pages,
                                     kv_dtype=kv_dtype)))


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_chunked_engine_matches_jax_engine(mix, overlap):
    _check_engine_parity(mix, overlap, "compute")


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_int8_engine_matches_jax_engine(mix, overlap):
    """int8 pages: the port's streams and counters equal the reference
    engine's on its own int8 stack, and the pool's gauges count the scale
    rows."""
    eng = _check_engine_parity(mix, overlap, "int8")
    pool = eng.pool
    leaf = pool.pages[0][0]
    assert leaf["k"].dtype == torch.int8
    assert set(leaf) == {"k", "v", "k_scale", "v_scale"}
    count, P, K, pt, hd = leaf["k"].shape
    assert pool.page_nbytes() == count * 2 * K * (pt * hd + 4)
    snap = eng.metrics_snapshot()["gauges"]
    assert snap["kv_quantized"] == 1
    assert snap["kv_page_nbytes"] == pool.page_nbytes()


def _check_engine_parity(mix, overlap, kv_dtype):
    streams, counters = _jax_run(mix, kv_dtype)
    eng = _port_engine(mix, overlap, kv_dtype)
    got = _run(eng, tengine.Request, mix)
    assert got == streams
    assert {k: eng.stats[k] for k in COUNTERS} == counters
    assert len(got) == len(MIXES[mix][0])
    s = eng.stats_summary()
    assert s["max_iter_tokens"] <= s["token_budget"]
    assert s["prefill_chunk_tokens"] >= sum(MIXES[mix][0])
    # one device→host transfer per iteration at most
    assert s["token_fetches"] <= len(eng.stats["iter_log"])
    pool = eng.pool
    assert pool.alloc.free_pages == pool.alloc.n_pages
    assert pool._reserved == {}
    pool.alloc.audit()
    if mix == "tight":
        assert counters["admission_refusals"] > 0
        assert counters["evictions_reprefill"] > 0
    return eng


def test_cache_manager_protocol_and_unported_layers():
    """All eight stacks ({paged, int8} × {±tiered} × {±prefix}) build and
    satisfy the protocol by static lookup; the tiered ones are subclasses
    of the pool with the prefix layer over the tier, as in the reference's
    layer order. (Every layer of the reference's stack is ported now.)"""
    eng = _port_engine("system")
    assert isinstance(eng.pool, tcache.CacheManager)
    cfg = eng.cfg
    from repro_torch.serve.kvcache import PagedCachePool
    from repro_torch.serve.tiering import TieredCachePool
    for tiered in (False, True):
        for prefix in (False, True):
            for kv_dtype in ("compute", "int8"):
                pool = tcache.build_cache_manager(
                    cfg, tcache.CacheConfig(tiered=tiered, prefix=prefix,
                                            kv_dtype=kv_dtype), 2, 32)
                assert isinstance(pool, tcache.CacheManager)
                assert isinstance(pool, PagedCachePool)
                assert (pool.prefix is not None) == prefix
                assert isinstance(pool, tcache.PrefixCachingPool) == prefix
                assert isinstance(pool, TieredCachePool) == tiered
                assert pool.quantized == (kv_dtype == "int8")
                if tiered and prefix:
                    mro = type(pool).__mro__
                    assert mro.index(tcache.PrefixCachingPool) < \
                        mro.index(TieredCachePool) < mro.index(PagedCachePool)
                if tiered:
                    assert pool.host_free_bytes() > 0 and not pool.cold_seqs()
    with pytest.raises(ValueError, match="kv_dtype"):
        tcache.build_cache_manager(cfg, tcache.CacheConfig(kv_dtype="fp8"),
                                   2, 32)


# --------------------------------------------------------------------------
# boundaries
# --------------------------------------------------------------------------
def _port_modules():
    pkg = SRC / "repro_torch"
    return ["repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
            for p in sorted(pkg.rglob("*.py")) if p.name != "__init__.py"]


def test_importing_every_port_module_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'\n"
            "print('ISOLATED')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=SRC,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr


def test_no_port_source_imports_jax_or_the_reference():
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, n)


def test_engine_without_a_card_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid here")
    tcfg = tconfigs.get_smoke_config("qwen2-0.5b")
    from repro_torch.models import transformer
    model = transformer.init_model(tcfg, torch.Generator().manual_seed(0))
    conf = tengine.EngineConfig(n_slots=2, max_seq=32, chunked=True,
                                token_budget=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.Engine(tcfg, model, config=conf)
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.Engine(tcfg, model, config=conf, device="cuda")
    eng = tengine.Engine(tcfg, model, config=conf, device="cpu")
    assert eng.pool.pages[0][0]["k"].device.type == "cpu"
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])


# --------------------------------------------------------------------------
# the reference's engine surface
# --------------------------------------------------------------------------
# name -> the keyword form's arguments (``config`` stands for an
# EngineConfig beside them)
KEYWORD_FORMS = {
    "flags": dict(n_slots=2, max_seq=32, page_tokens=8, n_pages=12,
                  paged=True, tiered=True, chunked_prefill=True,
                  token_budget=8, prefix_cache=True, prefix_cache_pages=4),
    "plain": dict(n_slots=2, max_seq=32),
    "stray": dict(config=True, max_seq=32, prefix_cache=True),
    "defaults_beside_config": dict(config=True, n_slots=4, greedy=True),
}
SURFACE = ("paged", "tiered", "chunked", "greedy", "token_budget",
           "preempt_quantum")


def _keyword_engine(pkg, kw):
    """(engine or the ValueError's text, the warnings' categories and
    texts) of one package's keyword form."""
    cfg, tree = _weights()
    if pkg == "jax":
        make, conf = JEngine, JEngineConfig
        model = jax.tree_util.tree_map(jnp.asarray, tree)
        extra = {}
    else:
        tcfg = tconfigs.get_smoke_config("qwen2-0.5b",
                                         compute_dtype=torch.float32)
        make, conf, cfg = tengine.Engine, tengine.EngineConfig, tcfg
        model, extra = params_from_numpy(tree, tcfg), dict(device="cpu")
    kw = dict(kw)
    if kw.pop("config", False):
        kw["config"] = conf(n_slots=2, max_seq=32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            eng = make(cfg, model, **kw, **extra)
        except ValueError as err:
            eng = str(err)
    return eng, [(w.category, str(w.message)) for w in caught]


@pytest.mark.parametrize("form", sorted(KEYWORD_FORMS))
def test_keyword_form_warns_and_refuses_as_the_reference(form):
    """The reference's keyword construction: its feature flags build the
    layered stack and warn (DeprecationWarning naming the config path);
    plain keywords build without a warning; a keyword beside ``config=``
    that differs from its default raises, one equal to it does not. The
    engines built serve a request to the reference's stream."""
    j, j_warn = _keyword_engine("jax", KEYWORD_FORMS[form])
    t, t_warn = _keyword_engine("port", KEYWORD_FORMS[form])
    if form == "stray":
        assert isinstance(j, str) and t == j
        assert "['max_seq', 'prefix_cache']" in t
        return
    assert [c for c, _ in t_warn] == [c for c, _ in j_warn]
    assert all("EngineConfig" in m for _, m in t_warn)
    assert bool(t_warn) == (form == "flags")
    for name in SURFACE:
        # the reference's dense scheduler sets no budget and no quantum
        if hasattr(j.scheduler, name):
            assert getattr(t, name) == getattr(j, name), name
    assert (t.prefix is None) == (j.prefix is None)
    assert hasattr(t.pool, "cold_seqs") == (form == "flags")
    prompt = _prompts("system")[1]
    got = []
    for eng, req in ((j, JRequest), (t, tengine.Request)):
        eng.submit(req(seq_id=0, prompt=prompt.copy(), max_new=3))
        got.append([list(r.tokens_out) for r in eng.run(200)])
    assert got[0] == got[1] and len(got[1][0]) == 3


def test_introspection_properties_are_the_scheduler_s():
    """``active`` / ``prefilling`` / ``prefilled_wait`` are the scheduler's
    own maps, mid-run as the reference's; ``metrics`` is the bus; the
    flags read as the reference engine's on the same config."""
    eng, _ = _keyword_engine("port", KEYWORD_FORMS["flags"])
    ref, _ = _keyword_engine("jax", KEYWORD_FORMS["flags"])
    for e, req in ((eng, tengine.Request), (ref, JRequest)):
        for i, p in enumerate(_prompts("system")):
            e.submit(req(seq_id=i, prompt=p.copy(), max_new=4))
        e.step()
        e.step()
    for name in ("active", "prefilling", "prefilled_wait"):
        assert getattr(eng, name) is getattr(eng.scheduler, name)
        assert sorted(r.seq_id for r in getattr(eng, name).values()) == \
            sorted(r.seq_id for r in getattr(ref, name).values()), name
    assert eng.metrics is eng.bus
    assert eng.metrics.snapshot()["counters"] == \
        ref.metrics.snapshot()["counters"]


def _traced_run(pkg, buffer):
    cfg, tree = _weights()
    kw = dict(n_slots=3, max_seq=64, chunked=True, token_budget=8,
              trace=True, trace_buffer=buffer, clock=ManualClock())
    if pkg == "jax":
        eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                      config=JEngineConfig(
                          **kw, cache=JCacheConfig(paged=True,
                                                   page_tokens=8)))
    else:
        tcfg = tconfigs.get_smoke_config("qwen2-0.5b",
                                         compute_dtype=torch.float32)
        eng = tengine.Engine(tcfg, params_from_numpy(tree, tcfg),
                             device="cpu", config=tengine.EngineConfig(
                                 **kw, cache=tcache.CacheConfig(
                                     page_tokens=8)))
    _run(eng, JRequest if pkg == "jax" else tengine.Request, "system")
    tr = eng.tracer
    return (tr.buffer, len(tr.events), tr.dropped,
            [(e["ph"], e["name"], e["tid"]) for e in tr.events])


@pytest.mark.parametrize("buffer", [16, 65536])
def test_trace_buffer_bounds_the_events_as_the_reference(buffer):
    """``EngineConfig.trace_buffer`` sizes the tracer's ring: the same
    retained window (kinds, names, tracks) and drop count as the
    reference's on the same run."""
    got, want = _traced_run("port", buffer), _traced_run("jax", buffer)
    assert got == want
    assert got[1] == min(buffer, got[1] + got[2])
    if buffer == 16:
        assert got[1] == 16 and got[2] > 0


def test_serve_cli_trace_buffer(tmp_path, capsys):
    from repro_torch.launch import serve
    path = tmp_path / "t.json"
    serve.main(["--device", "cpu", "--chunked-prefill", "--requests", "3",
                "--slots", "2", "--max-seq", "32", "--max-new", "3",
                "--page-tokens", "8", "--token-budget", "6", "--trace",
                str(path), "--trace-buffer", "32"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("[serve:trace]")]
    assert len(line) == 1 and " 32 events (" in line[0], out
    assert "0 dropped" not in line[0] and path.exists()


@pytest.mark.cuda
def test_cuda_kernels_match_their_plain_versions():
    """On the card: both kernels against their plain versions on the same
    CUDA tensors (atol 2e-3), and each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_engine.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, K, hd, pt, P = 4, 14, 2, 64, 16, 64
    q = torch.randn(B, H, hd, generator=g, device="cuda")
    kp = torch.randn(P, K, pt, hd, generator=g, device="cuda").bfloat16()
    vp = torch.randn(P, K, pt, hd, generator=g, device="cuda").bfloat16()
    table = torch.arange(B * 16, dtype=torch.int32, device="cuda").reshape(
        B, 16) % P
    lengths = torch.tensor([0, 16, 17, 256], dtype=torch.int32,
                           device="cuda")
    n0 = tpda.paged_flash_decode.launches
    out = tpda.paged_flash_decode(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert tpda.paged_flash_decode.launches == n0 + 1
    ref = tpda.paged_flash_decode_plain(q, kp, vp, table, lengths)
    assert (out - ref).abs().max().item() < 2e-3
    q2 = torch.randn(37, H, hd, generator=g, device="cuda")
    out = tppa.paged_flash_prefill(q2, kp, vp, table[3], 100)
    ref = tppa.paged_flash_prefill_plain(q2, kp, vp, table[3], 100)
    assert (out - ref).abs().max().item() < 2e-3
