"""Meshes: the reference's production meshes and a mesh over the ranks.

Counterpart of ``repro/launch/mesh.py``. :func:`make_production_mesh` gives
the reference's (pod, data, model) = (2, 16, 16) multi-pod or (16, 16)
single-pod shapes as an abstract mesh (shape only: the rules of
parallel/sharding.py resolve against it, nothing runs on it).
:func:`make_dev_mesh` spans the ranks of the running process group
(parallel/launch.py starts them) as (data, model). Functions, not module
constants: importing this module touches no process group.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.abstract(shape, axes)


def make_dev_mesh(n_devices: Optional[int] = None, model: int = 1) -> Mesh:
    """(data, model) = (n / model, model) over the ``n_devices`` ranks of
    the running process group (default: all of them)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if n % model:
        raise ValueError(f"{n} ranks do not split into model = {model}")
    return Mesh((n // model, model), ("data", "model"))


def chips(mesh: Mesh) -> int:
    return mesh.size
