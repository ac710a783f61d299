"""Checkpoints: one ``.npy`` a leaf, a manifest written last, async saves.

Counterpart of ``repro/checkpoint/manager.py``, on its layout exactly, so
that a checkpoint written by either package restores in the other: a step
lives in ``step_NNNNNNNN/``, one ``shard_NNNNN.npy`` a leaf in the tree's
flattening order (core/tree.py: JAX's order), and ``MANIFEST.json`` maps
each leaf's path (``.params/groups/0/0/mixer/wq``, ``.opt/.m/embed``,
``.step``) to its file, shape and dtype beside the ``step``, the caller's
``extra`` (the data step) and the time. The manifest is written last, by
an atomic rename, and the directory is published by another, so a crash
mid-save leaves no checkpoint that :meth:`CheckpointManager.restore`
would trust. A save snapshots the state to host memory at once and
writes it on one background thread (one save in flight at a time); the
newest ``keep`` steps are kept.

A checkpoint holds whole leaves, as the reference's host arrays are, so
it is the same file whatever mesh wrote it. :meth:`CheckpointManager.
restore` with ``shardings`` (a tree of parallel/sharding.py
``NamedSharding``, train/step.py ``state_shardings``) is the reference's
elastic path (``manager.py:124-140``): each rank takes its slice of each
saved leaf on the mesh it runs now, so a checkpoint written at 2 ranks
restores at 1 and the other way round (train/step.py ``whole_state``
gathers a sharded state's leaves to save them).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import tree as tree_lib

MANIFEST = "MANIFEST.json"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.save_stats: Dict[str, float] = {}

    # -- save --------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[Dict] = None,
             blocking: bool = True) -> str:
        """Snapshot ``state`` (a tree of tensors or arrays) to host memory
        now, write it now (``blocking``) or on the background thread."""
        t0 = time.perf_counter()
        host_state = tree_lib.tree_map(tree_lib.to_host, state)
        snap_s = time.perf_counter() - t0
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time

        def _write():
            self._write(step, host_state, extra or {})

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        self.save_stats = {"snapshot_s": snap_s}
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, host_state, extra: Dict):
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=self.dir)
        index = {}
        for i, (key, leaf) in enumerate(tree_lib.paths(host_state)):
            fn = f"shard_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), leaf)
            index[key] = {"file": fn, "shape": list(np.shape(leaf)),
                          "dtype": str(np.asarray(leaf).dtype)}
        manifest = {"step": step, "leaves": index, "extra": extra,
                    "time": time.time()}
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath + ".part", "w") as f:
            json.dump(manifest, f)
        os.rename(mpath + ".part", mpath)      # manifest last, atomic
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                  # atomic publish
        self.save_stats["write_s"] = time.perf_counter() - t0
        self._gc()

    def _gc(self):
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore -------------------------------------------------------------
    def list_steps(self) -> List[int]:
        """The steps with a manifest (a directory without one is a save
        that did not finish, and is ignored)."""
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and \
               os.path.exists(os.path.join(self.dir, d, MANIFEST)):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                shardings=None) -> Tuple[Any, Dict]:
        """(``template``'s tree holding the saved numpy arrays, the
        manifest's ``extra``) of ``step`` (default: the latest). With
        ``shardings`` (a tree of ``NamedSharding`` shaped as
        ``template``) each leaf is this rank's slice of the saved one.
        Raises when a leaf's saved shape (its slice's, with
        ``shardings``) is not the template's."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        leaves = []
        held = tree_lib.paths(template)
        where = ([None] * len(held) if shardings is None
                 else tree_lib.leaves(shardings))
        for (key, leaf), sh in zip(held, where):
            ent = manifest["leaves"][key]
            arr = np.load(os.path.join(d, ent["file"]))
            if sh is not None:
                arr = sh.shard_of(arr)
            if list(arr.shape) != list(np.shape(leaf)):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(np.shape(leaf))}")
            leaves.append(arr)
        return tree_lib.unflatten(template, leaves), manifest["extra"]
