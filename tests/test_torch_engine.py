"""The port's chunked serving engine against the JAX engine, and the
port's boundaries: no JAX inside it, no silent CPU, kernels on the card.

The main-path gate: the same weights and prompts through the JAX chunked
``Engine`` (Pallas in interpret mode) and the port's chunked ``Engine`` on
the CPU, both at the smoke config in f32, give equal greedy streams and
equal scheduling counters, with the overlapped loop on and off.
"""
import ast
import functools
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
from repro_torch.kernels import paged_decode_attention as tpda
from repro_torch.kernels import paged_prefill_attention as tppa
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import cache as tcache
from repro_torch.serve import engine as tengine

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
COUNTERS = ("prefill_chunks", "prefill_chunk_tokens", "decode_tokens",
            "decode_steps", "admission_refusals", "evictions_reprefill",
            "prefills")

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
def _jax_run(mix):
    cfg, tree = _weights()
    _, _, _, slots, max_seq, pt, pages, budget = MIXES[mix]
    eng = JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  config=JEngineConfig(
                      n_slots=slots, max_seq=max_seq, chunked=True,
                      token_budget=budget,
                      cache=JCacheConfig(paged=True, page_tokens=pt,
                                         n_pages=pages)))
    streams = _run(eng, JRequest, mix)
    return streams, {k: eng.stats[k] for k in COUNTERS}


def _port_engine(mix, overlap=True):
    _, tree = _weights()
    tcfg = tconfigs.get_smoke_config("qwen2-0.5b", compute_dtype=torch.float32)
    _, _, _, slots, max_seq, pt, pages, budget = MIXES[mix]
    return tengine.Engine(
        tcfg, params_from_numpy(tree, tcfg), device="cpu",
        config=tengine.EngineConfig(
            n_slots=slots, max_seq=max_seq, chunked=True, token_budget=budget,
            overlap=overlap,
            cache=tcache.CacheConfig(page_tokens=pt, n_pages=pages)))


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_chunked_engine_matches_jax_engine(mix, overlap):
    streams, counters = _jax_run(mix)
    eng = _port_engine(mix, overlap)
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


def test_cache_manager_protocol_and_unported_layers():
    eng = _port_engine("system")
    assert isinstance(eng.pool, tcache.CacheManager)
    cfg = eng.cfg
    for kw in (dict(tiered=True), dict(prefix=True), dict(kv_dtype="int8")):
        with pytest.raises(NotImplementedError):
            tcache.build_cache_manager(
                cfg, tcache.CacheConfig(**kw), 2, 32)


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
