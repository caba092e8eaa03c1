"""Offline pre-sharding of documents by path (paper §2.2, §2.4); the
port's own copy of ``repro/data/sharder.py``.

Sharding happens BEFORE training: each document's routing decision is
computed offline and the document is appended to its shard (or its top-n
shards when overlapping, §2.4.4).  Shards can be persisted as .npz for
the infra workers, in the reference's files: either package reads the
other's.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class PreShardedDataset:
    shards: list                    # list[np.ndarray (n_i, S)]
    assignments: np.ndarray         # (N,) or (N, topn) doc -> shard(s)
    num_shards: int
    holdout_frac: float = 0.0
    holdouts: list = field(default_factory=list)

    @property
    def sizes(self):
        return np.array([len(s) for s in self.shards])

    def alphas(self):
        """Shard-size weights (Eq. 3)."""
        sz = self.sizes.astype(np.float64)
        return sz / max(sz.sum(), 1.0)

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        for i, s in enumerate(self.shards):
            np.savez_compressed(os.path.join(path, f"shard_{i:04d}.npz"),
                                tokens=s)
            if self.holdouts:
                np.savez_compressed(
                    os.path.join(path, f"holdout_{i:04d}.npz"),
                    tokens=self.holdouts[i])
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"num_shards": self.num_shards,
                       "sizes": self.sizes.tolist(),
                       "holdout_frac": self.holdout_frac}, f)

    @classmethod
    def load(cls, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        shards, holdouts = [], []
        for i in range(meta["num_shards"]):
            shards.append(np.load(
                os.path.join(path, f"shard_{i:04d}.npz"))["tokens"])
            hp = os.path.join(path, f"holdout_{i:04d}.npz")
            if os.path.exists(hp):
                holdouts.append(np.load(hp)["tokens"])
        return cls(shards=shards, assignments=np.zeros(0, np.int32),
                   num_shards=meta["num_shards"],
                   holdout_frac=meta["holdout_frac"], holdouts=holdouts)


def shard_documents(docs: np.ndarray, assignments, num_shards: int, *,
                    holdout_frac: float = 0.0,
                    seed: int = 0) -> PreShardedDataset:
    """assignments: (N,) single or (N, topn) overlapping (§2.4.4)."""
    assignments = np.asarray(assignments)
    if assignments.ndim == 1:
        assignments = assignments[:, None]
    rng = np.random.default_rng(seed)
    shards, holdouts = [], []
    for i in range(num_shards):
        idx = np.nonzero((assignments == i).any(axis=1))[0]
        toks = docs[idx]
        if holdout_frac > 0 and len(toks) > 1:
            n_h = max(1, int(len(toks) * holdout_frac))
            perm = rng.permutation(len(toks))
            holdouts.append(toks[perm[:n_h]])
            toks = toks[perm[n_h:]]
        else:
            holdouts.append(toks[:0])
        shards.append(toks)
    return PreShardedDataset(shards=shards, assignments=assignments,
                             num_shards=num_shards,
                             holdout_frac=holdout_frac, holdouts=holdouts)
