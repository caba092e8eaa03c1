"""Global module store: the 'large model' that is never materialized as
one network — only as K_l module variants per level plus shared leaves;
the port of ``repro/core/module_store.py``.

Layout: for each level l, a param tree whose layer-stacked leaves have
shape (K_l, R_l, ...) — K_l module variants of the R_l repeat-groups in
that level.  Non-layer leaves (embeddings, final norm) live in
``shared`` — either one copy (shared_embeddings) or one per path.  The
store lives on the device of the template parameters.

Trees here hold ``None`` where a leaf belongs to another part of the
store, as the reference's do (``core.pytree``).  The store's tensors are
never written in place: ``set_module`` and ``set_shared`` build new
tensors and swap them in under a lock, so a tree that ``assemble`` or
``module_params`` handed out keeps its values (the reference's immutable
arrays).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.core import pytree
from repro_torch.core.partition import PathPartition
from repro_torch.models.params import LAYERS


def _is_layer_leaf(ax, shape, num_repeats):
    return (len(ax) >= 1 and ax[0] == LAYERS and len(shape) >= 1
            and shape[0] == num_repeats)


class ModuleStore:
    def __init__(self, template_params, axes, partition: PathPartition):
        self.axes = axes
        self.part = partition
        R = partition.boundaries[-1]
        self.num_repeats = R
        # "layer" | "shared" per leaf, in the template's structure
        self._kind = pytree.tree_map(
            lambda leaf, ax: ("layer" if _is_layer_leaf(ax, leaf.shape, R)
                              else "shared"),
            template_params, axes, is_leaf=lambda x: isinstance(x, tuple))
        # guards read-modify-write of level containers: concurrent outer
        # executors updating different experts of the same level must not
        # lose each other's writes
        self._write_lock = threading.Lock()
        self.levels = []
        for l in range(partition.num_levels):
            lo, hi = partition.boundaries[l], partition.boundaries[l + 1]
            K = int(max(partition.paths[:, l])) + 1

            def take(leaf, kind, lo=lo, hi=hi, K=K):
                if kind != "layer":
                    return None
                seg = leaf[lo:hi]
                return seg[None].repeat(K, *([1] * seg.ndim))

            self.levels.append(pytree.tree_map(take, template_params,
                                               self._kind))
        if partition.shared_embeddings:
            self.shared = pytree.tree_map(
                lambda leaf, kind: leaf if kind == "shared" else None,
                template_params, self._kind)
        else:
            Pn = partition.num_paths
            self.shared = pytree.tree_map(
                lambda leaf, kind: (leaf[None].repeat(Pn, *([1] * leaf.ndim))
                                    if kind == "shared" else None),
                template_params, self._kind)

    # ------------------------------------------------------------------
    # analysis: lockfree(readers see an atomic swap of immutable trees)
    def assemble(self, path_idx: int):
        """Materialize the parameter tree for path ``path_idx``."""
        segs = []
        for l in range(self.part.num_levels):
            e = self.part.module_of(path_idx, l)
            segs.append(self.module_params(l, e))

        def walk(kind_t, shared_t, *level_ts):
            if isinstance(kind_t, dict):
                return {k: walk(kind_t[k], shared_t[k],
                                *[lt[k] for lt in level_ts])
                        for k in kind_t}
            if kind_t == "shared":
                if self.part.shared_embeddings:
                    return shared_t
                return shared_t[path_idx]
            return torch.cat(list(level_ts), dim=0)

        return walk(self._kind, self.shared, *segs)

    # ------------------------------------------------------------------
    # analysis: lockfree(readers see an atomic swap of immutable trees)
    def module_params(self, level: int, expert: int):
        return pytree.tree_map(lambda x: x[expert], self.levels[level])

    def set_module(self, level: int, expert: int, new_tree):
        def setter(store_leaf, new_leaf):
            out = store_leaf.clone()
            out[expert] = new_leaf
            return out

        with self._write_lock:
            self.levels[level] = pytree.tree_map(
                setter, self.levels[level], new_tree)

    def set_shared(self, new_tree, path_idx=None):
        def setter(store_leaf, new_leaf):
            if self.part.shared_embeddings or path_idx is None:
                return new_leaf.to(store_leaf.dtype)
            out = store_leaf.clone()
            out[path_idx] = new_leaf
            return out

        with self._write_lock:
            self.shared = pytree.tree_map(setter, self.shared, new_tree)

    # ------------------------------------------------------------------
    def slice_for_level(self, tree, level: int):
        """Slice a full path tree's layer leaves to level ``level``."""
        lo, hi = self.part.boundaries[level], self.part.boundaries[level + 1]
        return pytree.tree_map(
            lambda leaf, kind: leaf[lo:hi] if kind == "layer" else None,
            tree, self._kind)

    def shared_of(self, tree):
        return pytree.tree_map(
            lambda leaf, kind: leaf if kind == "shared" else None,
            tree, self._kind)

    # analysis: lockfree(size probe; stale tree reference is fine)
    def num_params(self) -> int:
        n = 0
        for lvl in self.levels:
            n += sum(x.numel() for x in pytree.leaves(lvl))
        n += sum(x.numel() for x in pytree.leaves(self.shared))
        return n
