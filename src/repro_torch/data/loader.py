"""Deterministic per-shard batch loader (the port's own copy of
``repro/data/loader.py``: the same seeds give the same numpy streams,
bit for bit).  With-replacement sampling, so small shards can feed long
training, as in the paper's over-sampling discussion §2.7."""
from __future__ import annotations

import numpy as np


class ShardLoader:
    def __init__(self, tokens: np.ndarray, batch_size: int, seed: int = 0):
        if len(tokens) == 0:
            raise ValueError("empty shard")
        self.tokens = tokens
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> np.ndarray:
        idx = self.rng.integers(0, len(self.tokens), size=self.batch_size)
        return self.tokens[idx]

    def batches(self, n: int) -> np.ndarray:
        """(n, batch, S)."""
        return np.stack([self.next_batch() for _ in range(n)])


def phase_batches(tokens: np.ndarray, batch_size: int, tau: int,
                  shard_id: int, phase: int) -> np.ndarray:
    """Deterministic (tau, batch, S) batch schedule keyed by
    (shard, phase), recomputable after a worker is preempted."""
    rng = np.random.default_rng(1000 + shard_id * 131 + phase * 7919)
    idx = rng.integers(0, len(tokens), size=(tau, batch_size))
    return tokens[idx]
