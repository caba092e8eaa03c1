"""Streaming fragment-wise outer sync (Streaming DiLoCo, Douillard et
al. 2025); the port of ``repro/core/fragments.py``.

DiLoCo ships every shared module's full fp32 delta in one burst at each
phase boundary.  Streaming DiLoCo removes that bandwidth spike by

 * partitioning the parameter tree into K *fragments*, each synced on
   its own staggered schedule with an independent outer-optimizer
   state, and
 * quantizing the outer-gradient wire payload (symmetric int8/int4
   per-leaf scales) with an error-feedback residual kept worker-side so
   the quantization error telescopes instead of accumulating.

This module is the functional core: a deterministic leaf->fragment
partition (:class:`FragmentSpec`), the quantized wire codec, and the
error-feedback encoder.  The executors (infra/outer_executor.py) and
the training service (infra/service.py) build the windowed/staggered
machinery on top; ``core.diloco.streaming_outer_step`` is the
vectorized equivalence oracle.

Fragments are defined over the *flattened leaf list* of a tree
(``core.pytree.flatten``: the reference's ``jax.tree_util`` order, dict
keys sorted, ``None`` leaves skipped), so a fragment id means the same
leaf set for any tree with the same structure, in either package.  The
wire payloads are bit for bit the reference's: the same f32 operations
in the same order, rounding half to even, int4 as two's-complement
nibbles packed two to a byte (low nibble first).
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from repro_torch.core import pytree

COMM_DTYPES = ("fp32", "int8", "int4")

# symmetric quantization range per wire dtype
_QMAX = {"int8": 127, "int4": 7}
# simulated wire bytes per element (int4 packs two values per byte)
_ELEM_BYTES = {"fp32": 4.0, "int8": 1.0, "int4": 0.5}
# one fp32 scale per leaf rides along with a quantized payload
_SCALE_BYTES = 4


def _numel(x) -> int:
    return int(math.prod(tuple(x.shape)))


class FragmentSpec:
    """Deterministic partition of a tree's leaves into ``num_fragments``
    byte-balanced fragments.

    The assignment is a pure function of the template's leaf shapes:
    leaves are taken largest-first (ties broken by flatten order) and
    greedily placed on the lightest fragment, so every process that
    builds a spec from the same template agrees on the layout — the
    property resume and cross-process replay depend on.  ``K`` is
    clamped to the leaf count so no fragment is ever empty.
    """

    def __init__(self, template, num_fragments: int):
        leaves, self.treedef = pytree.flatten(template)
        if not leaves:
            raise ValueError("cannot fragment a tree with no leaves")
        self.num_leaves = len(leaves)
        self.num_fragments = max(1, min(int(num_fragments), self.num_leaves))
        sizes = [_numel(x) for x in leaves]
        self.leaf_sizes = list(sizes)
        order = sorted(range(self.num_leaves),
                       key=lambda i: (-sizes[i], i))
        self.assign = np.zeros(self.num_leaves, np.int32)
        load = np.zeros(self.num_fragments, np.int64)
        for i in order:
            fid = int(np.argmin(load))     # lightest fragment, lowest id
            self.assign[i] = fid
            load[fid] += sizes[i]
        self.indices = [
            [i for i in range(self.num_leaves) if self.assign[i] == f]
            for f in range(self.num_fragments)]
        self.elems = [int(sum(sizes[i] for i in idx))
                      for idx in self.indices]

    # ------------------------------------------------------------------
    def flatten(self, tree) -> list:
        """Leaf list of ``tree``, validated against the template."""
        leaves = pytree.leaves(tree)
        if len(leaves) != self.num_leaves:
            raise ValueError(
                f"tree has {len(leaves)} leaves, spec expects "
                f"{self.num_leaves}")
        return leaves

    def unflatten(self, leaves):
        return self.treedef.unflatten(leaves)

    def slice_leaves(self, tree, fragment: int) -> dict:
        """``{leaf_idx: leaf}`` for the leaves of ``fragment``."""
        leaves = self.flatten(tree)
        return {i: leaves[i] for i in self.indices[fragment]}

    def wire_bytes(self, fragment: int, comm_dtype="fp32") -> int:
        """Simulated bytes to ship this fragment's outer delta.
        ``comm_dtype`` is one dtype name for the whole fragment, or a
        per-leaf dtype list aligned with the template's flatten order."""
        if isinstance(comm_dtype, str):
            return _wire_bytes(self.elems[fragment],
                               len(self.indices[fragment]), comm_dtype)
        dts = _leaf_dtype_list(comm_dtype, self.num_leaves)
        return int(sum(_wire_bytes(self.leaf_sizes[i], 1, dts[i])
                       for i in self.indices[fragment]))

    def total_bytes(self, comm_dtype="fp32") -> int:
        return sum(self.wire_bytes(f, comm_dtype)
                   for f in range(self.num_fragments))


def _leaf_dtype_list(comm_dtype, num_leaves: int) -> list:
    """Normalize a ``str | per-leaf sequence`` comm dtype to a validated
    per-leaf list (flatten order)."""
    if isinstance(comm_dtype, str):
        if comm_dtype not in COMM_DTYPES:
            raise ValueError(
                f"comm_dtype {comm_dtype!r} not in {COMM_DTYPES}")
        return [comm_dtype] * num_leaves
    dts = list(comm_dtype)
    if len(dts) != num_leaves:
        raise ValueError(f"per-leaf comm_dtype list has {len(dts)} "
                         f"entries, tree has {num_leaves} leaves")
    for d in dts:
        if d not in COMM_DTYPES:
            raise ValueError(f"comm_dtype {d!r} not in {COMM_DTYPES}")
    return dts


def _wire_bytes(n_elems: int, n_leaves: int, comm_dtype: str) -> int:
    """Simulated wire bytes for ``n_elems`` elements across ``n_leaves``
    leaves (one fp32 scale rides with each quantized leaf)."""
    if comm_dtype not in COMM_DTYPES:
        raise ValueError(f"comm_dtype {comm_dtype!r} not in {COMM_DTYPES}")
    b = n_elems * _ELEM_BYTES[comm_dtype]
    if comm_dtype != "fp32":
        b += _SCALE_BYTES * n_leaves
    return int(np.ceil(b))


# ---------------------------------------------------------------------
# segment schedule (Streaming DiLoCo offset windows)
# ---------------------------------------------------------------------

def segment_bounds(tau: int, num_segments: int) -> list:
    """Inner-step cut points splitting a phase of ``tau`` steps into
    ``num_segments`` contiguous segments; remainder steps go to the
    earliest segments."""
    if tau < num_segments:
        raise ValueError(
            f"tau={tau} < num_segments={num_segments}: every fragment "
            f"needs at least one inner step in its offset window")
    base, rem = divmod(tau, num_segments)
    bounds = [0]
    for s in range(num_segments):
        bounds.append(bounds[-1] + base + (1 if s < rem else 0))
    return bounds


# ---------------------------------------------------------------------
# wire quantization (symmetric, per-leaf scale) + error feedback
# ---------------------------------------------------------------------

def _quantize(x, qmax: int):
    """-> (x in f32, its per-leaf scale, q as f32 integers in
    [-qmax, qmax]); an all-zero leaf has scale 0."""
    x = x.float()
    scale = torch.max(torch.abs(x)) / qmax
    q = torch.clip(torch.round(x / torch.where(scale > 0, scale, 1.0)),
                   -qmax, qmax)
    return x, scale, q


def _fake_quant_leaf(x, qmax: int):
    """Quantize-dequantize one fp32 leaf with a symmetric per-leaf
    scale.  An all-zero leaf round-trips to zeros (scale would be 0)."""
    x, scale, q = _quantize(x, qmax)
    return torch.where(scale > 0, q * scale, torch.zeros_like(x))


def fake_quantize(tree, comm_dtype):
    """Quantize-dequantize every leaf of ``tree`` — the value the
    receiver reconstructs from the int wire payload.  ``comm_dtype`` is
    one dtype name or a per-leaf list (flatten order); fp32 leaves pass
    through by reference."""
    if comm_dtype == "fp32":
        return tree
    if isinstance(comm_dtype, str):
        if comm_dtype not in _QMAX:
            raise ValueError(
                f"comm_dtype {comm_dtype!r} not in {COMM_DTYPES}")
        qmax = _QMAX[comm_dtype]
        return pytree.tree_map(lambda x: _fake_quant_leaf(x, qmax), tree)
    leaves, treedef = pytree.flatten(tree)
    dts = _leaf_dtype_list(comm_dtype, len(leaves))
    out = [x if d == "fp32" else _fake_quant_leaf(x, _QMAX[d])
           for x, d in zip(leaves, dts)]
    return treedef.unflatten(out)


# -- real wire payloads (what a transport actually ships) --------------
#
# ``encode_wire`` produces the byte-honest representation of a quantized
# payload: an int8 ``q`` buffer (two nibbles packed per byte for int4)
# plus one fp32 scale per leaf.  ``decode_wire`` reconstructs exactly the
# same fp32 values as :func:`fake_quantize` (the q and scale computations
# are the identical operation sequence).

def _encode_leaf(x, qmax: int, pack: bool):
    _, scale, q = _quantize(x, qmax)
    q = q.to(torch.int8)
    if pack:
        flat = q.reshape(-1)
        if flat.shape[0] % 2:
            flat = torch.cat([flat, flat.new_zeros(1)])
        lo, hi = flat[0::2].view(torch.uint8), flat[1::2].view(torch.uint8)
        # two's-complement nibbles: [-8, 7] covers qmax=7
        q = (((hi & 0xF) << 4) | (lo & 0xF)).view(torch.int8)
    return {"q": q, "scale": scale}


def _decode_leaf(payload, qmax: int, pack: bool, shape):
    q, scale = payload["q"], payload["scale"]
    if pack:
        u = q.view(torch.uint8)
        lo = (u & 0xF).to(torch.int8)
        lo = torch.where(lo > 7, lo - 16, lo)
        hi = (u >> 4).to(torch.int8)
        hi = torch.where(hi > 7, hi - 16, hi)
        n = math.prod(shape)
        q = torch.stack([lo, hi], dim=1).reshape(-1)[:n].reshape(shape)
    return torch.where(scale > 0, q.float() * scale,
                       torch.zeros(shape, dtype=torch.float32,
                                   device=q.device))


def encode_wire(tree, comm_dtype):
    """Encode an fp32 payload tree into its on-the-wire representation:
    the tree with each leaf replaced by ``{"q": int8, "scale": f32[]}``
    (int4 packs two values per ``q`` byte).  fp32 payloads (or fp32
    leaves of a per-leaf dtype list) pass through unchanged."""
    if comm_dtype == "fp32":
        return tree
    if isinstance(comm_dtype, str):
        if comm_dtype not in _QMAX:
            raise ValueError(
                f"comm_dtype {comm_dtype!r} not in {COMM_DTYPES}")
        qmax, pack = _QMAX[comm_dtype], comm_dtype == "int4"
        return pytree.tree_map(lambda x: _encode_leaf(x, qmax, pack), tree)
    leaves, treedef = pytree.flatten(tree)
    dts = _leaf_dtype_list(comm_dtype, len(leaves))
    out = [x if d == "fp32"
           else _encode_leaf(x, _QMAX[d], d == "int4")
           for x, d in zip(leaves, dts)]
    return treedef.unflatten(out)


def _is_wire_leaf(x) -> bool:
    return isinstance(x, dict) and "q" in x


def decode_wire(payload, comm_dtype, like):
    """Reconstruct the fp32 payload from :func:`encode_wire` output.
    ``like`` supplies leaf shapes (the int4 packing flattens them).
    ``decode_wire(encode_wire(x)) == fake_quantize(x)`` bitwise."""
    if comm_dtype == "fp32":
        return payload
    shapes = [tuple(x.shape) for x in pytree.leaves(like)]
    leaves, treedef = pytree.flatten(payload, is_leaf=_is_wire_leaf)
    if isinstance(comm_dtype, str):
        qmax, pack = _QMAX[comm_dtype], comm_dtype == "int4"
        out = [_decode_leaf(p, qmax, pack, s)
               for p, s in zip(leaves, shapes)]
        return treedef.unflatten(out)
    dts = _leaf_dtype_list(comm_dtype, len(leaves))
    out = [p if d == "fp32"
           else _decode_leaf(p, _QMAX[d], d == "int4", s)
           for p, s, d in zip(leaves, shapes, dts)]
    return treedef.unflatten(out)


def payload_nbytes(payload, comm_dtype) -> int:
    """Measured bytes of an encoded payload (``q`` buffers + scales for
    quantized leaves, raw fp32 buffers otherwise)."""
    if comm_dtype == "fp32":
        return sum(_numel(x) * 4 for x in pytree.leaves(payload))
    leaves = pytree.leaves(payload, is_leaf=_is_wire_leaf)
    return sum(_numel(p["q"]) + _SCALE_BYTES if _is_wire_leaf(p)
               else _numel(p) * 4 for p in leaves)


def quantize_with_feedback(delta, residual, comm_dtype, *,
                           return_payload: bool = False):
    """Encode ``delta`` for the wire with error feedback.

    Returns ``(wire, new_residual)``: ``wire`` is the dequantized
    payload the receiver folds (== ``delta`` for fp32), and
    ``new_residual`` is the quantization error the *sender* keeps and
    adds to its next delta.  ``residual=None`` means no carried error.
    ``return_payload=True`` appends the :func:`encode_wire`
    representation; ``decode_wire`` of it equals ``wire`` bitwise."""
    if comm_dtype == "fp32":
        return (delta, None, delta) if return_payload else (delta, None)
    pre = delta if residual is None else pytree.tree_map(
        lambda d, r: d.float() + r, delta, residual)
    wire = fake_quantize(pre, comm_dtype)
    new_residual = pytree.tree_map(lambda p, w: p.float() - w, pre, wire)
    if return_payload:
        return wire, new_residual, encode_wire(pre, comm_dtype)
    return wire, new_residual


def tree_wire_bytes(tree, comm_dtype="fp32") -> int:
    """Simulated wire bytes for a whole tree payload."""
    leaves = pytree.leaves(tree)
    if isinstance(comm_dtype, str):
        n = sum(_numel(x) for x in leaves)
        return _wire_bytes(n, len(leaves), comm_dtype)
    dts = _leaf_dtype_list(comm_dtype, len(leaves))
    return int(sum(_wire_bytes(_numel(x), 1, d)
                   for x, d in zip(leaves, dts)))


def fragment_send_slot(fragment: int, stagger: int, num_fragments: int
                       ) -> int:
    """Send-schedule slot of ``fragment`` within a phase.  Slot 0 is the
    phase boundary itself; ``stagger=0`` puts every fragment in slot 0
    (the classic DiLoCo burst)."""
    return (fragment * stagger) % num_fragments


# ---------------------------------------------------------------------
# heterogeneous-fleet policies: per-leaf comm dtypes + bandwidth-aware
# fragment schedules
# ---------------------------------------------------------------------

COMM_DTYPE_POLICIES = ("uniform", "leafwise")

# leaves whose path names match any of these stay fp32 under the
# leafwise policy (norm gains and embeddings: tiny, precision-critical)
_FP32_LEAF_NAMES = ("norm", "embed", "bias", "scale")


def leaf_comm_dtypes(template, base_dtype: str = "int8", *,
                     large_elems: int = 1 << 16,
                     fp32_names=_FP32_LEAF_NAMES) -> list:
    """Per-leaf wire dtypes for ``template`` (flatten order): fp32 for
    norms, embeddings and vectors, int4 for matmul leaves of at least
    ``large_elems`` elements, ``base_dtype`` for the rest."""
    if base_dtype not in COMM_DTYPES:
        raise ValueError(
            f"base_dtype {base_dtype!r} not in {COMM_DTYPES}")
    out = []
    for name, x in pytree.flatten_with_path(template):
        name = name.lower()
        shape = tuple(x.shape)
        if any(tok in name for tok in fp32_names) or len(shape) < 2:
            out.append("fp32")
        elif math.prod(shape) >= large_elems and base_dtype != "fp32":
            out.append("int4")
        else:
            out.append(base_dtype)
    return out


def resolve_comm_dtype(policy: str, comm_dtype: str, template):
    """Resolve a config ``(comm_dtype_policy, comm_dtype)`` pair into the
    value the codec functions take: the plain dtype string under
    ``"uniform"`` or a per-leaf list under ``"leafwise"`` (``"fp32"``
    when that list is all fp32)."""
    if policy not in COMM_DTYPE_POLICIES:
        raise ValueError(
            f"comm_dtype_policy {policy!r} not in {COMM_DTYPE_POLICIES}")
    if policy == "uniform":
        return comm_dtype
    dts = leaf_comm_dtypes(template, comm_dtype)
    if all(d == "fp32" for d in dts):
        return "fp32"
    return dts


def bandwidth_slots(spec: FragmentSpec, stagger: int, comm_dtype="fp32",
                    *, bandwidth: float | None = None,
                    ref_bandwidth: float | None = None) -> list:
    """Per-fragment send slots for one worker's link profile: a slow
    link re-ranks fragments by ascending wire bytes before the
    :func:`fragment_send_slot` formula."""
    K = spec.num_fragments
    ranks = list(range(K))
    if (bandwidth is not None and ref_bandwidth
            and bandwidth < ref_bandwidth):
        order = sorted(range(K),
                       key=lambda f: (spec.wire_bytes(f, comm_dtype), f))
        rank_of = {f: r for r, f in enumerate(order)}
        ranks = [rank_of[f] for f in range(K)]
    return [fragment_send_slot(ranks[f], stagger, K) for f in range(K)]


def leaf_bytes(x) -> bytes:
    """The raw bytes of one leaf as numpy holds it (bf16 as its 16
    bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def payload_checksum(payload) -> int:
    """crc32 over the raw bytes of every payload leaf (encoded ``q`` /
    ``scale`` dicts and fp32 buffers alike), in flatten order."""
    crc = 0
    for x in pytree.leaves(payload):
        crc = zlib.crc32(leaf_bytes(x), crc)
    return crc & 0xFFFFFFFF
