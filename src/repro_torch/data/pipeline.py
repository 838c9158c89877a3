"""Deterministic, shard-aware token data pipeline (counterpart of
``repro/data/pipeline.py``, a numpy copy of it: the port imports nothing
of the JAX package).

Sources: synthetic (seeded zipfian over the vocab, which the examples and
the train driver use) or a memmapped token file. Every host computes its
own shard of each global batch purely from (seed, step, host_id), with
the reference's ``np.random.SeedSequence([seed, step, host_id])`` and
draws, so a batch is bitwise the reference's: no coordination,
reproducible across restarts, and an elastic resize changes only
(n_hosts, host_id) while the global stream stays the same. A background
thread prefetches batches. Batches are numpy int32 arrays; the driver
moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    source: str = "synthetic"        # synthetic | file
    path: Optional[str] = None       # token file (np.int32 memmap) for "file"


class TokenPipeline:
    """get_batch(step, host_id, n_hosts) -> {"tokens","labels"} host shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.source == "file":
            if not cfg.path:
                raise ValueError("the file source needs a path")
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def host_batch_size(self, n_hosts: int) -> int:
        if self.cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {self.cfg.global_batch} does "
                             f"not divide over {n_hosts} hosts")
        return self.cfg.global_batch // n_hosts

    def get_batch(self, step: int, host_id: int = 0, n_hosts: int = 1):
        cfg = self.cfg
        bh = self.host_batch_size(n_hosts)
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        if cfg.source == "synthetic":
            # zipfian-ish ranks: realistic logits distribution for LM loss
            ranks = rng.zipf(1.3, size=(bh, cfg.seq_len + 1))
            tokens = np.minimum(ranks, cfg.vocab_size - 1).astype(np.int32)
        else:
            n = len(self._mm) - cfg.seq_len - 1
            starts = rng.integers(0, n, size=(bh,))
            tokens = np.stack([self._mm[s:s + cfg.seq_len + 1]
                               for s in starts]).astype(np.int32)
            tokens = np.minimum(tokens, cfg.vocab_size - 1)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def iterator(self, start_step: int = 0, host_id: int = 0,
                 n_hosts: int = 1, prefetch: int = 2) -> Iterator:
        """Prefetching iterator from ``start_step`` (resume-friendly).

        The producer thread is leak-free: a full queue is waited on with a
        timeout so the producer re-checks ``stop`` (a producer blocked on a
        plain ``q.put`` would never observe ``stop.set()`` after the
        consumer exits), and the ``finally`` drains the queue and joins the
        thread, so closing the iterator releases the thread immediately."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                batch = self.get_batch(step, host_id, n_hosts)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            try:                     # unblock a producer mid-put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=2.0)


def write_token_file(path: str | Path, tokens: np.ndarray):
    np.asarray(tokens, np.int32).tofile(path)
