"""Parameter trees: nested dicts of tensors with the JAX tree's keys,
shapes and dtypes, plus the numpy bridge to and from the reference.

A JAX ``bfloat16`` leaf arrives in numpy as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` rejects; it crosses as its raw 16 bits
(an ``int16`` view), so the round trip is bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

ParamTree = Any  # nested dict[str, ParamTree | torch.Tensor]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16 type, a dependency of JAX's
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy_tree(tree: ParamTree, device="cuda") -> ParamTree:
    """Nested dict of numpy (or array-like) leaves -> tensors on device."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, dev), tree)


def to_numpy_tree(params: ParamTree) -> ParamTree:
    """Nested dict of tensors -> numpy leaves (bf16 as ml_dtypes)."""
    return tree_map(_leaf_to_numpy, params)


def cast_tree(params: ParamTree, dtype: torch.dtype) -> ParamTree:
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, params)
