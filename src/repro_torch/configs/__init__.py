"""Architecture registry for the port.

Each ``<arch>.py`` exposes ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family config for the CPU tests). Only
the architectures the port runs are registered here: GQA with swiglu or
squared-ReLU MLPs or a capacity-dispatched MoE, full-attention or
sliding-window, served by the engines; the recurrent families
(xlstm-1.3b's mLSTM / sLSTM, zamba2-1.2b's Mamba2 with its weight-shared
attention block), served by the dense engine only, as in the reference;
the cross-attention archs (llama-3.2-vision-11b, whisper-medium with
its encoder), which run through the prefill / decode steps of
``train/step.py`` only, as in the reference; and deepseek-v3-671b (MLA
over a latent cache, 256 experts with a shared one), served by the dense
engine only, as in the reference. Every arch of the reference's zoo is
registered, and each one trains (train/step.py, launch/train.py) through
the no-cache forward, deepseek's MLA and MTP head among it.

The shape table is the reference's, copied as it is: train_4k runs the
train step, prefill_32k the prefill step, decode_* the decode step (one
token against a seq_len cache); ``long_500k`` needs sub-quadratic
attention and runs only for the archs of ``LONG_OK``. :func:`all_cells`
gives the 33 run cells the dry run (launch/dryrun.py) walks.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCHS: Tuple[str, ...] = ("qwen2-0.5b", "yi-34b", "minitron-4b",
                           "gemma3-27b", "granite-moe-3b-a800m",
                           "llama-3.2-vision-11b", "whisper-medium",
                           "xlstm-1.3b", "zamba2-1.2b", "deepseek-v3-671b")

# long_500k runs only where attention cost is sub-quadratic / state-based
LONG_OK = {"xlstm-1.3b", "zamba2-1.2b", "gemma3-27b"}


def _module(arch: str):
    if arch not in ARCHS:
        raise NotImplementedError(
            f"repro_torch: arch {arch!r} is not ported yet (ported: {ARCHS}; "
            "ROADMAP queue 1, item 16)")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, **overrides):
    cfg = _module(arch).config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str, **overrides):
    cfg = _module(arch).smoke_config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def cells(arch: str) -> List[ShapeSpec]:
    """The (arch × shape) cells that are RUN (skips per DESIGN recorded)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and arch not in LONG_OK:
            continue
        out.append(s)
    return out


def skipped_cells(arch: str) -> List[Tuple[str, str]]:
    if arch not in LONG_OK:
        return [("long_500k", "full-attention arch: 500k decode cache is "
                 "quadratic-prefill lineage; skipped per assignment, see "
                 "DESIGN §Arch-applicability")]
    return []


def all_cells() -> List[Tuple[str, ShapeSpec]]:
    return [(a, s) for a in ARCHS for s in cells(a)]
