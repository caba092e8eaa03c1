"""Dry-run cases on the meta device; the port of ``repro/launch/specs.py``.

``build_case(cfg, shape, mesh)`` assembles one (architecture x input
shape x mesh) case: the step function, its arguments as meta tensors
(their shapes and dtypes, no storage), the logical axes and the spec
(``launch/sharding.py``) of every argument leaf, and ``static``.  Nothing
is allocated.  ``mesh`` is a ``launch.mesh.LogicalMesh``.

The port runs one DiPaCo worker a rank, so every worker-stacked leaf
(its logical axes begin with ``WORKER``) splits over the ranks by rows
(``Case.local_args``); the specs say how the reference's mesh would lay
the same leaves out, tensor-parallel island included, for bytes a
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.partition import make_partition, mixing_matrices
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.models.config import DiPaCoConfig, InputShape, ModelConfig
from repro_torch.models.layers import torch_dtype
from . import steps as S
from .mesh import WorkerMesh, num_workers as mesh_num_workers
from .sharding import DEFAULT_RULES, spec_for

CACHE_SEQ = "cache_seq"
RULES = dict(DEFAULT_RULES)
RULES[CACHE_SEQ] = ("model",)
RULES["enc_seq"] = ()
META = torch.device("meta")


def rules_for(cfg: ModelConfig) -> dict:
    """Per-arch sharding rules.  island_parallelism == "data": within an
    island the 16 "model" devices data-parallelize the worker's batch and
    replicate the (small) path params, so the step's collective is one
    param-sized gradient all-reduce instead of 4L activation
    all-reduces."""
    if cfg.island_parallelism != "data":
        return RULES
    r = dict(RULES)
    for name in (P.HEADS, P.KV_HEADS, P.MLP, P.EXPERT, P.EXPERT_MLP,
                 P.VOCAB, P.SSM_INNER):
        r[name] = ()
    r[P.BATCH] = ("model", ("pod", "data"))
    return r


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _stack(tree, n: int):
    return P.tree_map(lambda s: s.new_empty((n, *s.shape)), tree)


def _prepend(axes, lead: tuple):
    return P.tree_map(lambda ax: (*lead, *ax), axes)


# ---------------------------------------------------------------------------
# Cache shape/axes trees (parallel to models.api.init_serve_cache)
# ---------------------------------------------------------------------------
def decode_cache_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    dtype = torch_dtype(cfg.dtype)
    kv_ax = (P.LAYERS, P.BATCH, CACHE_SEQ, P.KV_HEADS, P.HEAD_DIM)
    if api.is_encdec(cfg):
        kv = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
              cfg.head_dim)
        return ({"k": meta(kv, dtype), "v": meta(kv, dtype)},
                {"k": kv_ax, "v": kv_ax})
    reps = cfg.pattern_repeats
    shapes, axes = {}, {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "attn":
            kv = (reps, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
            kv_dtype = torch.int8 if cfg.kv_quant else dtype
            shapes[f"pos{i}"] = {"k": meta(kv, kv_dtype),
                                 "v": meta(kv, kv_dtype)}
            axes[f"pos{i}"] = {"k": kv_ax, "v": kv_ax}
            if cfg.kv_quant:
                sc_ax = kv_ax[:-1]
                for name in ("k_scale", "v_scale"):
                    shapes[f"pos{i}"][name] = meta(kv[:-1], torch.float32)
                    axes[f"pos{i}"][name] = sc_ax
        else:
            from repro_torch.models.ssm import ssm_dims
            d_inner, n_heads, conv_dim = ssm_dims(cfg)
            shapes[f"pos{i}"] = {
                "conv": meta((reps, batch, cfg.ssm.conv_width - 1,
                              conv_dim), dtype),
                "ssm": meta((reps, batch, n_heads, cfg.ssm.head_dim,
                             cfg.ssm.d_state), torch.float32),
            }
            axes[f"pos{i}"] = {
                "conv": (P.LAYERS, P.BATCH, P.CONV, P.SSM_INNER),
                "ssm": (P.LAYERS, P.BATCH, P.HEADS, P.HEAD_DIM, P.SSM_STATE),
            }
    return shapes, axes


# ---------------------------------------------------------------------------
# Batch input specs
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, shape: InputShape, mesh, *,
                stacked: bool = True):
    """Token (+frontend stub) inputs: (meta tree, logical axes tree)."""
    W = mesh_num_workers(mesh) if stacked else 1
    gb = shape.global_batch
    assert gb % W == 0 or not stacked, (gb, W)
    b_local = gb // W if stacked else gb
    lead = (P.WORKER,) if stacked else ()
    lead_dim = (W,) if stacked else ()
    seq = 1 if shape.kind == "decode" else shape.seq_len
    dtype = torch_dtype(cfg.dtype)
    out = {"tokens": meta((*lead_dim, b_local, seq), torch.int32)}
    axes = {"tokens": (*lead, P.BATCH, P.SEQ)}
    if cfg.vision is not None and shape.kind != "decode":
        out["patch_embeds"] = meta(
            (*lead_dim, b_local, cfg.vision.num_patches, cfg.vision.d_patch),
            torch.float32)
        axes["patch_embeds"] = (*lead, P.BATCH, "enc_seq", None)
    if cfg.encoder is not None:
        src = cfg.encoder.source_len
        if shape.kind == "decode":
            out["enc_out"] = meta((*lead_dim, b_local, src, cfg.d_model),
                                  dtype)
            axes["enc_out"] = (*lead, P.BATCH, "enc_seq", P.EMBED)
            if cfg.cross_kv_cache:
                kv = (*lead_dim, cfg.num_layers, b_local, src,
                      cfg.num_kv_heads, cfg.head_dim)
                kv_ax = (*lead, P.LAYERS, P.BATCH, "enc_seq", P.KV_HEADS,
                         P.HEAD_DIM)
                out["cross_kv"] = {"k": meta(kv, dtype), "v": meta(kv, dtype)}
                axes["cross_kv"] = {"k": kv_ax, "v": kv_ax}
        else:
            out["frames"] = meta((*lead_dim, b_local, src,
                                  cfg.encoder.d_source), torch.float32)
            axes["frames"] = (*lead, P.BATCH, "enc_seq", None)
    return out, axes


# ---------------------------------------------------------------------------
# Dry-run cases
# ---------------------------------------------------------------------------
@dataclass
class Case:
    """A step function and its meta arguments.  ``names`` labels the
    arguments ("params", "optimizer", "cache", "inputs", ...); ``axes``
    holds each argument's logical-axes tree and ``specs`` its spec tree
    under ``rules``."""

    name: str
    fn: Callable
    args: tuple
    names: tuple
    axes: tuple
    specs: tuple
    static: dict

    def local_args(self, ranks: int, rank: int = 0) -> tuple:
        """The arguments as one of ``ranks`` ranks holds them: its rows of
        every worker-stacked leaf, the rest whole."""
        W = self.static["workers"]
        n = W // ranks
        rows = slice(rank * n, (rank + 1) * n)

        def cut(x, ax):
            return x[rows] if ax and ax[0] == P.WORKER else x

        return tuple(P.tree_map(cut, a, ax)
                     for a, ax in zip(self.args, self.axes))


def _case(name, fn, static, mesh, rules, *named) -> Case:
    """named: (name, meta tree, axes tree) for each argument."""
    specs = tuple(P.tree_map(
        lambda x, ax: spec_for(tuple(ax), tuple(x.shape), mesh,
                               rules or RULES), a, ax)
        for _, a, ax in named)
    return Case(name=name, fn=fn, args=tuple(a for _, a, _ in named),
                names=tuple(n for n, _, _ in named),
                axes=tuple(ax for _, _, ax in named), specs=specs,
                static=static)


def _dipaco_partition_for(cfg: ModelConfig, W: int):
    """Default 4x4 = 16-path partition used by the dry-run."""
    reps = cfg.pattern_repeats
    if reps >= 2:
        dcfg = DiPaCoConfig(levels=(4, 4))
    else:
        dcfg = DiPaCoConfig(levels=(16,))
    part = make_partition(dcfg, reps)
    worker_paths = np.arange(W) % part.num_paths
    mixl, mixs = mixing_matrices(part, worker_paths)
    return part, mixl, mixs


def build_train_case(cfg: ModelConfig, shape: InputShape, mesh) -> Case:
    W = mesh_num_workers(mesh)
    pshapes, axes = S.worker_param_shapes(cfg, W)
    waxes = _prepend(axes, (P.WORKER,))
    opt = S.adamw_state_shapes(pshapes)
    opt["count"] = meta((W,), torch.int32)
    opt_axes = {"m": waxes, "v": waxes, "count": (P.WORKER,)}
    batch, baxes = batch_specs(cfg, shape, mesh, stacked=True)
    return _case(f"{cfg.name}:{shape.name}:train",
                 S.make_inner_train_step(cfg), {"workers": W}, mesh,
                 rules_for(cfg), ("params", pshapes, waxes),
                 ("optimizer", opt, opt_axes), ("inputs", batch, baxes),
                 ("lr", meta((), torch.float32), ()))


def build_outer_case(cfg: ModelConfig, shape: InputShape, mesh) -> Case:
    """The outer step across workers: the port's fragment reduce
    (``steps.make_fragment_reduce_step``), one fragment of every leaf:
    each rank all_gathers its rows of the f32 outer gradient and mixes
    the full leaves.  It runs under a fake world of one rank a worker."""
    from repro_torch.core import pytree
    from repro_torch.core.diloco import leaf_axes_list
    W = mesh_num_workers(mesh)
    pshapes, axes = S.worker_param_shapes(cfg, W)
    leaves, _ = pytree.flatten(pshapes)
    ax_list = leaf_axes_list(pshapes, axes)
    wire = {i: torch.empty_like(x, dtype=torch.float32)
            for i, x in enumerate(leaves)}
    wire_axes = {i: (P.WORKER, *ax) for i, ax in enumerate(ax_list)}
    part, mixl, mixs = _dipaco_partition_for(cfg, W)
    world = WorkerMesh(world=W, rank=0, device=META, backend="fake",
                       group=None, num_workers=W)
    return _case(f"{cfg.name}:{shape.name}:outer",
                 S.make_fragment_reduce_step(world, ax_list),
                 {"workers": W, "paths": part.num_paths}, mesh, RULES,
                 ("wire", wire, wire_axes),
                 ("mix_layers", meta(mixl.shape, torch.float32),
                  (None, None, None)),
                 ("mix_shared", meta(mixs.shape, torch.float32),
                  (None, None)))


def build_prefill_case(cfg: ModelConfig, shape: InputShape, mesh) -> Case:
    W = mesh_num_workers(mesh)
    pshapes, axes = S.worker_param_shapes(cfg, W)
    batch, baxes = batch_specs(cfg, shape, mesh, stacked=True)
    return _case(f"{cfg.name}:{shape.name}:prefill",
                 S.make_prefill_step(cfg), {"workers": W}, mesh,
                 rules_for(cfg),
                 ("params", pshapes, _prepend(axes, (P.WORKER,))),
                 ("inputs", batch, baxes))


def build_decode_case(cfg: ModelConfig, shape: InputShape, mesh) -> Case:
    stacked = shape.global_batch > 1
    W = mesh_num_workers(mesh) if stacked else 1
    cache_len = shape.window or shape.seq_len
    b_local = shape.global_batch // W if stacked else shape.global_batch
    cshapes, caxes = decode_cache_shapes(cfg, b_local, cache_len)
    if stacked:
        pshapes, axes = S.worker_param_shapes(cfg, W)
        axes = _prepend(axes, (P.WORKER,))
        cshapes = _stack(cshapes, W)
        caxes = _prepend(caxes, (P.WORKER,))
    else:
        pshapes, axes = S.model_param_shapes(cfg)
    batch, baxes = batch_specs(cfg, shape, mesh, stacked=stacked)
    return _case(f"{cfg.name}:{shape.name}:decode",
                 S.make_decode_step(cfg, window=shape.window,
                                    stacked=stacked),
                 {"workers": W, "cache_len": cache_len}, mesh, RULES,
                 ("params", pshapes, axes), ("inputs", batch, baxes),
                 ("cache", cshapes, caxes),
                 ("index", meta((), torch.int32), ()))


def build_case(cfg: ModelConfig, shape: InputShape, mesh) -> Case:
    if shape.kind == "train":
        return build_train_case(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill_case(cfg, shape, mesh)
    return build_decode_case(cfg, shape, mesh)


# ---------------------------------------------------------------------------
# Model-FLOPs reference (6*N_active*D) for the roofline table
# ---------------------------------------------------------------------------
def active_param_count(cfg: ModelConfig) -> tuple:
    """(total, active) parameter counts from the shape rules (no
    allocation)."""
    flat = P.tree_axes_flatten(P.param_shapes(cfg), P.param_axes(cfg))
    total = 0
    active = 0.0
    for path, shape, ax in flat:
        n = math.prod(shape)
        total += n
        if cfg.moe is not None and P.EXPERT in ax and "router" not in path[-1]:
            frac = cfg.moe.top_k / cfg.moe.num_experts
            active += n * frac
        else:
            active += n
    return total, int(active)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    total, active = active_param_count(cfg)
    # exclude embedding table from the 6ND rule-of-thumb
    embed = cfg.vocab_size * cfg.d_model
    n = max(active - embed, 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per request
    return 2.0 * n * tokens
