"""Architecture registry for the port.

Each ``<arch>.py`` exposes ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family config for the CPU tests). Only
the architectures the ported serving path runs are registered here; the
others arrive with the model zoo (ROADMAP queue 1, item 16).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

ARCHS: Tuple[str, ...] = ("qwen2-0.5b",)


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
