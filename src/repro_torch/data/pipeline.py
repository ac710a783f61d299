"""Deterministic synthetic data with restart skip-ahead.

A numpy copy of ``repro/data/pipeline.py``: a batch is a pure function of
(seed, step, host), so a restart resumes by setting the step, and the
checkpoint records nothing of the data but that integer. The stream is a
zipf-ish unigram mix over the vocabulary overlaid with a repeating n-gram
pattern, so the loss can fall. :class:`PrefetchLoader` makes batches on a
host thread, ``depth`` ahead, and puts them on the given torch device.
As in the reference, the training driver (launch/train.py) calls
:func:`make_batch` itself: :func:`make_batches` and the loader have no
caller in the package yet.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    ngram_period: int = 97      # structure the synthetic stream is built on
    mtp: bool = False           # also emit t+2 targets (deepseek MTP)


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def synth_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """[host_batch, seq_len + 2] int32."""
    hb = cfg.global_batch // cfg.n_hosts
    rng = _batch_rng(cfg, step)
    L = cfg.seq_len + 2
    base = (rng.zipf(1.3, size=(hb, L)) - 1) % cfg.vocab
    phase = rng.integers(0, cfg.ngram_period, size=(hb, 1))
    t = np.arange(L)[None, :]
    pattern = (t + phase) % cfg.ngram_period % cfg.vocab
    use_pattern = rng.random((hb, L)) < 0.7
    toks = np.where(use_pattern, pattern, base)
    return toks.astype(np.int32)


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """``tokens`` / ``labels`` [hb, seq_len] (labels one ahead), and under
    ``mtp`` ``next_tokens`` (one ahead) / ``mtp_labels`` (two ahead)."""
    toks = synth_tokens(cfg, step)
    b = {"tokens": toks[:, :-2], "labels": toks[:, 1:-1]}
    if cfg.mtp:
        b["next_tokens"] = toks[:, 1:-1]
        b["mtp_labels"] = toks[:, 2:]
    return b


def make_batches(cfg: DataConfig, start_step: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Skip-ahead restart: pass the restored step."""
    step = start_step
    while True:
        yield make_batch(cfg, step)
        step += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class PrefetchLoader:
    """Host-side prefetch: a thread makes ``(step, batch)`` pairs ``depth``
    ahead of the consumer, each batch's arrays already on ``device`` (numpy
    arrays when ``device`` is None)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 device=None):
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._device = device
        self._thread = threading.Thread(
            target=self._worker, args=(start_step,), daemon=True)
        self._thread.start()

    def _worker(self, start_step: int):
        step = start_step
        while not self._stop.is_set():
            b = make_batch(self.cfg, step)
            if self._device is not None:
                b = to_device(b, self._device)
            try:
                self._q.put((step, b), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
