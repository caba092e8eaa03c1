"""Path-composition partition (paper §2.3, §2.6); the port of
``repro/core/partition.py`` (numpy, equal to the reference exactly).

A base model's stacked layer groups (``pattern_repeats`` repeats of the
layer pattern) are partitioned into ``L`` contiguous *levels*; level ``l``
has ``K_l`` interchangeable modules.  A *path* is one module choice per
level; ``P = prod(K_l)``.

The partition also produces the **mixing matrices** used by the DiLoCo
outer step: ``mix[r, w, v]`` is the weight with which worker ``v``'s outer
gradient of repeat-group ``r`` contributes to worker ``w``'s module update
(Algorithm 1 line 13, plus §2.7 loss-reweighing and sqrt-rescaling).
Workers through the same module share identical rows, so after the outer
step their module copies remain synchronized.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

from repro_torch.models.config import DiPaCoConfig


@dataclass(frozen=True)
class PathPartition:
    levels: tuple            # K_l per level
    boundaries: tuple        # len L+1, repeat-index cut points (0 .. R)
    paths: np.ndarray        # (P, L) expert index per level, all product paths
    path_specific_levels: tuple = ()
    shared_embeddings: bool = True

    @property
    def num_levels(self):
        return len(self.levels)

    @property
    def num_paths(self):
        return self.paths.shape[0]

    def level_of_repeat(self, r: int) -> int:
        for l in range(self.num_levels):
            if self.boundaries[l] <= r < self.boundaries[l + 1]:
                return l
        raise ValueError(f"repeat {r} outside boundaries {self.boundaries}")

    def module_of(self, path_idx: int, level: int) -> int:
        return int(self.paths[path_idx, level])


def make_partition(dcfg: DiPaCoConfig, num_repeats: int) -> PathPartition:
    levels = tuple(dcfg.levels)
    L = len(levels)
    if dcfg.level_boundaries:
        boundaries = (0, *dcfg.level_boundaries, num_repeats)
    else:
        boundaries = tuple(round(i * num_repeats / L) for i in range(L + 1))
    if boundaries[0] != 0 or boundaries[-1] != num_repeats:
        raise ValueError(f"boundaries {boundaries} must run from 0 to "
                         f"{num_repeats}")
    if not all(b2 > b1 for b1, b2 in zip(boundaries, boundaries[1:])):
        raise ValueError(f"empty level in {boundaries} "
                         f"(num_repeats={num_repeats}, L={L})")
    paths = np.array(list(itertools.product(*[range(k) for k in levels])),
                     dtype=np.int32)
    # path-specific levels: every path gets its own module at that level
    psl = tuple(dcfg.path_specific_levels)
    if psl:
        paths = paths.copy()
        for l in psl:
            paths[:, l] = np.arange(paths.shape[0])
    return PathPartition(levels=levels, boundaries=boundaries, paths=paths,
                         path_specific_levels=psl,
                         shared_embeddings=dcfg.shared_embeddings)


def paths_through_module(part: PathPartition, level: int, expert: int):
    return np.nonzero(part.paths[:, level] == expert)[0]


def mixing_matrices(part: PathPartition, worker_paths, alphas=None, *,
                    grad_norm_rescale: bool = True):
    """Build (mix_layers (R,W,W), mix_shared (W,W)) as f32 numpy arrays.

    worker_paths: (W,) path index hosted by each worker.
    alphas: (W,) shard-size weights (Eq. 3); uniform if None.
    """
    worker_paths = np.asarray(worker_paths)
    W = len(worker_paths)
    R = part.boundaries[-1]
    if alphas is None:
        alphas = np.ones(W)
    alphas = np.asarray(alphas, np.float64)
    mix = np.zeros((R, W, W))
    for r in range(R):
        l = part.level_of_repeat(r)
        a = part.paths[worker_paths, l]          # (W,) module id per worker
        same = (a[:, None] == a[None, :]).astype(np.float64)
        wgt = same * alphas[None, :]
        denom = wgt.sum(axis=1, keepdims=True)
        m = wgt / np.maximum(denom, 1e-12)
        if grad_norm_rescale:
            # Delta(l,e) <- Delta(l,e) * sqrt(P_le)  (paper §2.7)
            count = same.sum(axis=1, keepdims=True)
            m = m * np.sqrt(count)
        mix[r] = m
    if part.shared_embeddings:
        wgt = np.broadcast_to(alphas[None, :], (W, W)).copy()
        m = wgt / wgt.sum(axis=1, keepdims=True)
        if grad_norm_rescale:
            m = m * np.sqrt(W)
        mix_shared = m
    else:
        mix_shared = np.eye(W)
    return mix.astype(np.float32), mix_shared.astype(np.float32)
