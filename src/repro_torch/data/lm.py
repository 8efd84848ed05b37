"""Generic LM data pipeline: packed random-token streams + host prefetch.

A numpy copy of ``repro.data.lm`` for the port: the same seed gives
bit-identical batches.

Used by the train_4k driver for architectures whose "real" corpus is out of
scope (the dry-run only needs shapes; smoke training uses the synthetic
reasoning task).  Implements the standard pieces a production pipeline has:
deterministic shard-aware sampling, packing, and a double-buffered prefetch
iterator.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def lm_batches(vocab_size: int, batch: int, seq_len: int, *, seed=0,
               num_batches: Optional[int] = None,
               shard_index: int = 0, shard_count: int = 1) -> Iterator[dict]:
    """Deterministic stream of {tokens, loss_mask} batches."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, shard_index]))
    i = 0
    while num_batches is None or i < num_batches:
        local = batch // shard_count
        toks = rng.integers(3, vocab_size, (local, seq_len), dtype=np.int32)
        yield {"tokens": toks,
               "loss_mask": np.ones((local, seq_len), np.float32)}
        i += 1


def prefetch(it: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Host-side double-buffering (overlaps data gen with device steps)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
