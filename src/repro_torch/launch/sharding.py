"""Logical-axis -> mesh-axis rules (MaxText-style); the port of
``repro/launch/sharding.py`` over a mesh known only by its ``shape``
mapping (axis name -> size), such as ``launch.mesh.LogicalMesh``.

Each logical axis maps to a priority list of mesh-axis candidates; a
candidate is taken only if (a) its mesh axes exist, (b) none is already
used by an earlier dimension of the same tensor, and (c) the dimension is
divisible by the candidate's total size.  Otherwise the dimension is
replicated, an honest fallback that the roofline then exposes.

A spec is a plain tuple with one entry a dimension: ``None``
(replicated), a mesh-axis name, or a tuple of names (the reference's
``PartitionSpec`` entries).  The port builds no sharded tensors from it:
the dry-run reads it for bytes a device (``launch/dryrun.py``).
"""
from __future__ import annotations

import math

from repro_torch.models import params as P

# priority lists; entries are a mesh axis name or tuple of names
DEFAULT_RULES: dict = {
    P.WORKER: (("pod", "data"), "data"),
    P.BATCH: (("pod", "data"), "data"),
    P.HEADS: ("model",),
    P.KV_HEADS: ("model",),
    P.MLP: ("model",),
    P.EXPERT: ("model",),
    P.EXPERT_MLP: ("model",),
    P.VOCAB: ("model",),
    P.SSM_INNER: ("model",),
    # never sharded:
    P.LAYERS: (), P.EMBED: (), P.HEAD_DIM: (), P.SEQ: (), P.CONV: (),
    P.SSM_STATE: (), None: (),
}


def axes_size(mesh, cand) -> int:
    """The devices a spec entry spans (1 for ``None``)."""
    if cand is None:
        return 1
    axs = cand if isinstance(cand, tuple) else (cand,)
    return math.prod(mesh.shape[a] for a in axs)


def spec_for(axes: tuple, shape: tuple, mesh, rules: dict | None = None
             ) -> tuple:
    rules = rules or DEFAULT_RULES
    used: set = set()
    parts = []
    for name, dim in zip(axes, shape):
        choice = None
        for cand in rules.get(name, ()):
            axs = cand if isinstance(cand, tuple) else (cand,)
            if any(a not in mesh.shape or a in used for a in axs):
                continue
            if dim > 0 and dim % axes_size(mesh, cand) == 0:
                choice = cand
                used.update(axs)
                break
        parts.append(choice)
    return tuple(parts)


def shardings_for_tree(params_shape, axes, mesh, *, prepend=(),
                       rules: dict | None = None):
    """Map a (shapes, axes) tree to spec tuples.  ``params_shape``'s
    leaves are tensors (meta ones, typically) or shape tuples.

    ``prepend``: logical axes prepended to every leaf (e.g. ("worker",)
    for worker-stacked trees).
    """
    def one(leaf, ax):
        shape = tuple(getattr(leaf, "shape", leaf))
        return spec_for(tuple(prepend) + tuple(ax), shape, mesh, rules)

    return P.tree_map_with_axes(one, params_shape, axes)


def replicated(mesh) -> tuple:
    return ()


def worker_stacked_sharding(mesh) -> tuple:
    """The spec of worker-stacked (W, ...) leaves: the leading worker
    axis over the mesh's worker axes, everything else replicated, the
    layout the fragment reduce (launch/steps.py) assumes."""
    return (("pod", "data") if "pod" in mesh.shape else "data",)


def batch_sharding(mesh, ndim: int, *, batch_dim: int = 0) -> tuple:
    parts = [None] * ndim
    cand = ("pod", "data") if "pod" in mesh.shape else ("data",)
    parts[batch_dim] = cand if len(cand) > 1 else cand[0]
    return tuple(parts)


def device_bytes(shape: tuple, itemsize: int, spec: tuple, mesh) -> float:
    """Bytes of one device's shard of a leaf laid out by ``spec``."""
    n = math.prod(shape) * itemsize
    return n / math.prod(axes_size(mesh, c) for c in spec)
