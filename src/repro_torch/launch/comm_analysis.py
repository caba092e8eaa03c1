"""Collective accounting and roofline terms of the dry-run; the
counterpart of ``repro/launch/hlo_analysis.py``, which parses them out of
compiled HLO.  The port has no HLO: ``record_collectives`` records the
``torch.distributed`` collectives a step calls, under the fake process
group of ``fake_world`` (no communication, any world size, meta tensors
accepted).

Collective cost model (bytes a device moves), as the reference's:
  all-reduce          2 x result bytes   (reduce-scatter + all-gather ring)
  all-gather          result bytes
  reduce-scatter      result bytes
  all-to-all          result bytes
  collective-permute  result bytes
  broadcast           result bytes

The H100 constants below are the single home of the card's peaks: the
dry-run's roofline, ``chip_smoke.py`` and ``tools/kernel_timing.py`` read
them from here.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict

import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit ("NVIDIA H100 80GB HBM3,
# 700 W"), dense rates from the NVIDIA H100 Tensor Core GPU data sheet:
# bf16 and TF32 on the tensor cores, f32 outside them, and HBM3.
# ---------------------------------------------------------------------------
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  "tf32": 495e12}
PEAK_FLOPS_BF16 = PEAK_OPS_PER_S[torch.bfloat16]
HBM_BYTES_PER_S = 3.35e12
# Interconnect a GPU, one direction.  NVLink 4 within an 8-GPU node: 18
# links, 900 GB/s both ways (H100 data sheet, SXM5), so 450e9 each way.
# Across nodes: one 400 Gb/s ConnectX-7 NIC a GPU (NVIDIA DGX H100 user
# guide), 50e9 B/s.
NODE_GPUS = 8
NVLINK_BYTES_PER_S = 450e9
NETWORK_BYTES_PER_S = 50e9

_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0}


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size()


# torch.distributed function -> (the reference's op name, the argument
# that holds the result)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 0),
    "all_gather": ("all-gather", 0),
    "all_gather_into_tensor": ("all-gather", 0),
    "reduce_scatter": ("reduce-scatter", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "all_to_all": ("all-to-all", 0),
    "all_to_all_single": ("all-to-all", 0),
    "broadcast": ("broadcast", 0),
}


@contextlib.contextmanager
def record_collectives():
    """Within the block, every collective called through
    ``torch.distributed`` appends ``(op, result bytes, 1)`` to the list
    it yields, then runs as it would."""
    records: list = []
    saved = {name: getattr(dist, name) for name in _COLLECTIVES}

    def wrap(name, fn):
        op, arg = _COLLECTIVES[name]

        def call(*args, **kw):
            records.append((op, _nbytes(args[arg]), 1))
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield records
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks as the default group,
    this process rank 0, for the block: collectives return at once and
    move nothing.  Raises where this PyTorch has no fake backend, and
    where the process already has a default group (the fake world
    cannot sit beside it)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the dry-run's fake process group is not available in torch "
            f"{torch.__version__}: {e}") from e
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs its own fake process group, "
                           "and this process already has a default one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def collective_stats(records) -> dict:
    """Counts and modelled bytes a device of ``(op, result bytes,
    count)`` records, in the reference's dict."""
    counts: dict = defaultdict(int)
    bytes_: dict = defaultdict(float)
    for op, nbytes, n in records:
        counts[op] += n
        bytes_[op] += nbytes * _MULT[op] * n
    return {
        "counts": dict(counts),
        "bytes_by_op": dict(bytes_),
        "total_bytes": float(sum(bytes_.values())),
        "total_count": int(sum(counts.values())),
    }


def link_bytes_per_s(mesh, axes) -> float:
    """The per-GPU rate of a collective over mesh ``axes``: NVLink where
    each group it spans sits in one 8-GPU node, the network otherwise.
    Devices are laid out row-major, the last axis fastest, so a group
    over ``axes`` lies within the devices of its first axis and every
    later one."""
    names = list(mesh.axis_names)
    first = min(names.index(a) for a in axes)
    span = math.prod(mesh.shape[a] for a in names[first:])
    return NVLINK_BYTES_PER_S if span <= NODE_GPUS else NETWORK_BYTES_PER_S


def roofline_terms(*, total_flops: float, total_bytes: float,
                   collective_bytes_per_device: float, chips: int,
                   link_bytes_per_s: float = NETWORK_BYTES_PER_S) -> dict:
    """All three roofline terms in seconds, on H100s.

    total_flops / total_bytes are whole-program (all devices); collective
    bytes are a device's, moved at ``link_bytes_per_s``.
    """
    compute_s = total_flops / (chips * PEAK_FLOPS_BF16)
    memory_s = total_bytes / (chips * HBM_BYTES_PER_S)
    collective_s = collective_bytes_per_device / link_bytes_per_s
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms
