"""Carry reference weights into the port.

``params_from_numpy`` takes the reference parameter tree with its leaves
already turned into numpy arrays (``blocks.split_params(init_model(...))[0]``
mapped through ``np.asarray``) and builds the port's
:class:`~repro_torch.models.transformer.Transformer`. Both sides use the
same layout, so every leaf is a copy: no transpose, no reshape.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.transformer import ModelConfig, Transformer


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, device) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, device) for v in tree)
    return _tensor(tree, device)


def params_from_numpy(tree, cfg: ModelConfig, device="cpu") -> Transformer:
    """Reference tree (numpy leaves: ``embed``, ``final_norm``,
    ``groups[gi][pos]`` with ``ln1``, ``mixer.{wq,wk,wv,wo,bq,bk,bv}``,
    ``ln2``, ``ffn.{w_gate,w_up,w_down}``) → the port's module on
    ``device``."""
    keep = {k: tree[k] for k in ("embed", "final_norm", "groups", "lm_head")
            if k in tree}
    return Transformer(cfg, _map(keep, torch.device(device)))
