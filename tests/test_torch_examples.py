"""The port's examples (examples/*_torch.py) on the CPU at smoke size.

Each imports only ``repro_torch`` (no JAX, nothing of the reference
package), runs on ``cuda`` unless given ``--device cpu`` and raises
without a card instead of falling back to the CPU; each runs here
in-process through its ``main``: the quickstart's gemm against the f64
oracle, the batch server's streams equal to the config-built engine's,
every AutoDMA demo mode against the oracle, and a few smoke training steps
of train_lm_torch (whose 100M config keeps the JAX example's shape).
"""
import ast
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart_torch", "serve_batch_torch", "train_lm_torch",
         "autodma_demo_torch")


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port_and_needs_a_card(name, tmp_path):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid here")
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_lm_torch" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main(argv)


def test_quickstart_on_the_cpu(capsys):
    out = _load("quickstart_torch").main(["--device", "cpu"])
    assert out["rel_err"] < 1e-6 and out["launches"] == 0
    text = capsys.readouterr().out
    assert "AutoDMA plan: tiles=" in text and "mode=autodma" in text


def test_serve_batch_on_the_cpu():
    """The keyword-built dense engine serves every request, with the
    streams of the same engine built from an EngineConfig."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    done, eng = _load("serve_batch_torch").main(
        ["--device", "cpu", "--requests", "5", "--max-new", "4"])
    assert len(done) == 5 and all(len(r.tokens_out) == 4 for r in done)
    assert not eng.paged and eng.config.n_slots == 4
    cfg = configs.get_smoke_config("qwen2-0.5b",
                                   compute_dtype=torch.float32)
    ref = Engine(cfg, transformer.init_model(
        cfg, torch.Generator().manual_seed(0)), device="cpu",
        config=EngineConfig(n_slots=4, max_seq=96))
    rng = np.random.default_rng(0)
    for i in range(5):
        ref.submit(Request(seq_id=i, prompt=rng.integers(
            0, cfg.vocab, 6).astype(np.int32), max_new=4))
    want = {r.seq_id: r.tokens_out for r in ref.run(2000)}
    assert {r.seq_id: r.tokens_out for r in done} == want


def test_autodma_demo_on_the_cpu():
    rows = _load("autodma_demo_torch").main(["--device", "cpu", "--size",
                                             "128"])
    assert [r["mode"] for r in rows] == ["unmodified", "paper", "autodma",
                                         "handwritten"]
    assert all(r["max_abs_err"] < 1e-3 for r in rows), rows


def test_train_lm_on_the_cpu(tmp_path):
    mod = _load("train_lm_torch")
    losses = mod.main(["--device", "cpu", "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path)])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    cfg = mod.config_100m()         # the JAX example's shape
    assert (cfg.d_model, cfg.n_layers(), cfg.vocab) == (640, 10, 32000)
