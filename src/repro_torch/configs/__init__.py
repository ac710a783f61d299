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
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

ARCHS: Tuple[str, ...] = ("qwen2-0.5b", "yi-34b", "minitron-4b",
                           "gemma3-27b", "granite-moe-3b-a800m",
                           "llama-3.2-vision-11b", "whisper-medium",
                           "xlstm-1.3b", "zamba2-1.2b", "deepseek-v3-671b")


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
