"""Model weights made by the benchmark from ``--seed``: one
``torch.Generator`` on the run's device, one draw a leaf, in the dtype
the configuration states.  Program and reference get the same numbers:
the program the tree below, the reference the same leaves in f32.

The tree has the program's layout (``repro_torch.models.lm.init_lm``'s
keys and shapes; ``check_layout`` holds the two together) and its
scales; the numbers are the benchmark's own.
"""
from __future__ import annotations

import torch

from bench.reference.model import family

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_specs(m: dict) -> list:
    """(key path, shape, std) of every leaf of the configuration ``m``
    (``configs/<name>.json``'s ``model``), as its architecture's
    reference lays them out; std 0 means a norm scale of ones."""
    return family(m).leaf_specs(m)


def _put(tree: dict, key: tuple, value) -> None:
    for k in key[:-1]:
        tree = tree.setdefault(k, {})
    tree[key[-1]] = value


def make_paths(m: dict, seed: int, num_paths: int, device,
               dtype=None) -> list:
    """``num_paths`` weight trees, drawn one after another from one
    generator seeded with ``seed``; in ``dtype`` (default: the
    configuration's)."""
    dtype = dtype or DTYPES[m["dtype"]]
    gen = torch.Generator(device=device).manual_seed(seed)
    paths = []
    for _ in range(num_paths):
        tree: dict = {}
        for key, shape, std in leaf_specs(m):
            if std == 0.0:
                leaf = torch.ones(shape, dtype=dtype, device=device)
            else:
                leaf = torch.randn(shape, generator=gen, device=device,
                                   dtype=DTYPES[m["dtype"]]).mul_(std)
                leaf = leaf.to(dtype)
            _put(tree, key, leaf)
        paths.append(tree)
    return paths


def flat(tree: dict, prefix: tuple = ()) -> dict:
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def check_layout(m: dict, program_shapes: dict) -> None:
    """Raise unless the benchmark's tree has the program's keys and
    shapes (``repro_torch.models.params.param_shapes``)."""
    ours = {"/".join(k): tuple(s) for k, s, _ in leaf_specs(m)}
    theirs = {k: tuple(v) for k, v in flat(program_shapes).items()}
    if ours != theirs:
        raise ValueError(f"weight layout differs from the program's: "
                         f"{sorted(set(ours.items()) ^ set(theirs.items()))}")
