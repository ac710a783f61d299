"""Carry weights between the reference's tree and the port.

``params_from_numpy`` takes the reference parameter tree with its leaves
already turned into numpy arrays (``blocks.split_params(init_model(...))[0]``
mapped through ``np.asarray``) and builds the port's
:class:`~repro_torch.models.transformer.Transformer`; ``params_to_numpy``
is the way back, the port's leaves as that numpy tree (checkpoints, the
tests). Both sides use the same layout, so every leaf is a copy: no
transpose, no reshape. ``rank_params_from_numpy`` gives one rank's shard
of that tree on a mesh (cut on the host by train/step.py ``shard_model``
before it moves to the device): the model the serving steps run on that
rank.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.models.transformer import (ModelConfig, Transformer,
                                            param_tree)
from repro_torch.parallel import sharding
from repro_torch.train.step import shard_model


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
    ``ln2``, ``ffn.{w_gate,w_up,w_down}``, ``ffn.{w_in,w_out}`` for a
    squared-ReLU MLP, ``ffn.{w_in,b_in,w_out,b_out}`` for a GELU one or
    ``ffn.{router,w_gate,w_up,w_down}`` (with
    ``ffn.shared.{w_gate,w_up,w_down}`` when the config has shared
    experts) for a MoE, a layer norm's ``bias`` beside its ``scale``,
    ``lm_head`` when the embedding is untied, ``pos_embed`` under learned
    positions, the ``encoder`` subtree ``{groups, final_norm, pos_embed}``
    of an encoder-decoder, a recurrent layer's ``mixer`` leaves of
    models/ssm.py, zamba2's unstacked ``shared_block.{mixer, ffn}``
    beside its sites' norms, an MLA layer's ``mixer.{w_dq, q_norm, w_uq,
    w_dkv, kv_norm, w_kr, w_uk, w_uv, wo}``, and deepseek-v3's ``mtp.{proj,
    block, norm}`` with ``block`` one unstacked layer) → the port's module
    on ``device``. Every leaf keeps its dtype (a MoE router and an mLSTM's
    ``w_if`` stay f32)."""
    if not cfg.tie_embeddings and "lm_head" not in tree:
        raise ValueError(f"{cfg.name}: an untied model needs its lm_head")
    keep = {k: tree[k] for k in ("embed", "final_norm", "groups", "lm_head",
                                 "pos_embed", "encoder", "shared_block",
                                 "mtp")
            if k in tree}
    return Transformer(cfg, _map(keep, torch.device(device)))


def rank_params_from_numpy(tree, cfg: ModelConfig, mesh: sharding.Mesh,
                           device="cpu") -> Transformer:
    """This rank's shard of the reference tree on ``mesh`` under the active
    rules (``sharding.use_mesh``): :func:`params_from_numpy` on the host,
    cut there by train/step.py ``shard_model`` (which sets
    ``model.shards``), then moved to ``device``."""
    return shard_model(params_from_numpy(tree, cfg), mesh).to(device)


def params_to_numpy(model: Transformer):
    """The port's leaves as the reference's tree of numpy arrays (each a
    host copy at its leaf's dtype; a bf16 leaf comes back as f32, numpy
    having no bfloat16)."""
    return tree_lib.tree_map(tree_lib.to_host, param_tree(model))
