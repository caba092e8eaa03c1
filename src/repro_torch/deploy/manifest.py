"""Deployment manifests: immutable descriptions of one servable model
version; the port of ``repro/deploy/manifest.py``.

A DiPaCo "version" is not one weight blob — it is a *composition*: one
checkpoint row per module (level, expert) plus the shared leaves
(paper §2.3: a path is a choice of module per level; §2.4/App. A: each
module checkpoints independently and continuously).  A manifest pins
that composition: for every module id it records the content digest of
the exact parameter payload, so

 * two manifests that share a module reference share its bytes (shared
   modules are materialized once and reused by every path through
   them), and
 * promote/rollback are exact — a version is its digest tuple, nothing
   ambient.

``file=None`` marks a module still at its base initialization (no outer
update has been applied yet); the registry materializes those from its
construction-time template, whose digest is recorded all the same.

The JSON and the digests are the reference's, so either package reads a
registry the other wrote: ``tree_digest`` hashes the leaves in
``jax.tree_util`` order (``core.pytree``, ``None`` dropped), each as
numpy's dtype name (``"bfloat16"``, ``"float32"``), the ``str`` of its
shape tuple and its raw bytes (a bfloat16 leaf's 16 bits).
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from repro_torch.core import pytree

# module id of the shared-leaves executor (embeddings / final norm)
SHARED_ID = (-1, -1)


def file_digest(path: str) -> str:
    """Content hash of a checkpoint file (identity of a module payload)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _leaf_bytes(leaf) -> tuple:
    """-> (numpy dtype name, shape tuple, raw bytes) of one leaf."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return str(a.dtype), tuple(a.shape), a.tobytes()
    t = leaf.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy() \
            .tobytes()
    a = t.numpy()
    return str(a.dtype), tuple(a.shape), a.tobytes()


def tree_digest(tree) -> str:
    """Content hash of a parameter tree (used for base-init modules,
    which have no checkpoint file to hash)."""
    h = hashlib.sha256()
    for leaf in pytree.leaves(tree):
        dtype, shape, raw = _leaf_bytes(leaf)
        h.update(dtype.encode())
        h.update(str(shape).encode())
        h.update(raw)
    return h.hexdigest()


@dataclass(frozen=True)
class ModuleRef:
    """One module's pinned payload inside a manifest."""
    level: int
    expert: int
    digest: str
    file: str | None = None      # None = base initialization (template)
    phase: int = -1              # outer phase of the applied update
    step: int = -1               # executor update counter

    @property
    def module_id(self) -> tuple:
        return (self.level, self.expert)


@dataclass(frozen=True)
class Manifest:
    """A servable version: module-id -> pinned payload."""
    version: int
    refs: tuple                  # tuple[ModuleRef, ...]
    parent: int = -1             # version this candidate was cut from
    created_at: float = field(default_factory=time.time)
    note: str = ""
    # the completed outer phase this candidate was cut at (a ref's row
    # phase can run ahead of it under staggered fragments); -1 = a
    # manifest from before fragments (min over the ref phases).  Not
    # part of the signature: a version is its composition.
    cut_phase: int = -1

    def __post_init__(self):
        ids = [r.module_id for r in self.refs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate module ids in manifest: {ids}")

    @property
    def by_id(self) -> dict:
        return {r.module_id: r for r in self.refs}

    @property
    def signature(self) -> tuple:
        """Digest tuple in module-id order — the version's identity."""
        return tuple(r.digest for r in
                     sorted(self.refs, key=lambda r: r.module_id))

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version, "parent": self.parent,
            "created_at": self.created_at, "note": self.note,
            "cut_phase": self.cut_phase,
            "refs": [asdict(r) for r in self.refs]}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        d = json.loads(text)
        return cls(version=d["version"], parent=d.get("parent", -1),
                   created_at=d.get("created_at", 0.0),
                   note=d.get("note", ""),
                   cut_phase=d.get("cut_phase", -1),
                   refs=tuple(ModuleRef(**r) for r in d["refs"]))
