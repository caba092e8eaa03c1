"""Parameter trees: nested dicts of tensors with the JAX tree's keys,
shapes and dtypes, the logical-axes tree that the reference's
``init_model`` returns beside them (``param_axes``), and the numpy bridge
to and from the reference.

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
AxisTree = Any   # same structure, leaves: tuple[str | None, ...]

# logical axis names of the reference (repro/models/params.py)
WORKER = "worker"       # DiPaCo path-worker (island) axis
LAYERS = "layers"       # stacked layer axis
BATCH = "batch"
SEQ = "seq"
EMBED = "embed"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"
VOCAB = "vocab"
EXPERT = "expert"
EXPERT_MLP = "expert_mlp"
SSM_INNER = "ssm_inner"
SSM_STATE = "ssm_state"
CONV = "conv"


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` and of parallel trees ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves) -> ParamTree:
    """The tree of ``template``'s structure with ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_map_with_axes(fn, params: ParamTree, axes: AxisTree):
    """Map fn(leaf, axes_leaf) over parallel trees."""
    return tree_map(fn, params, axes)


def _layout(cfg):
    """Every leaf of ``init_model(cfg)`` as a tuple of (logical axis,
    size) pairs, one a dimension: the shape rules of the reference's
    ``init_*``.  Layer leaves carry ``LAYERS`` first."""
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": ((EMBED, d), (HEADS, h), (HEAD_DIM, hd)),
            "wk": ((EMBED, d), (KV_HEADS, kh), (HEAD_DIM, hd)),
            "wv": ((EMBED, d), (KV_HEADS, kh), (HEAD_DIM, hd)),
            "wo": ((HEADS, h), (HEAD_DIM, hd), (EMBED, d))}
    if cfg.qk_norm:
        attn["q_norm"] = ((HEAD_DIM, hd),)
        attn["k_norm"] = ((HEAD_DIM, hd),)

    def mlp(f):
        out = {"w_up": ((EMBED, d), (MLP, f)),
               "w_down": ((MLP, f), (EMBED, d))}
        if cfg.mlp_type in ("swiglu", "geglu"):
            out = {"w_gate": ((EMBED, d), (MLP, f)), **out}
        return out

    moe = None
    if cfg.moe is not None:
        m = cfg.moe
        e, fe = m.num_experts, m.d_ff_expert
        moe = {"router": ((EMBED, d), (EXPERT, e)),
               "w_gate": ((EXPERT, e), (EMBED, d), (EXPERT_MLP, fe)),
               "w_up": ((EXPERT, e), (EMBED, d), (EXPERT_MLP, fe)),
               "w_down": ((EXPERT, e), (EXPERT_MLP, fe), (EMBED, d))}
        if m.num_shared > 0:
            moe["shared"] = mlp(m.d_ff_shared or m.num_shared * fe)
    mamba = None
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * d
        heads = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.n_groups * s.d_state
        proj_out = 2 * d_inner + 2 * s.n_groups * s.d_state + heads
        mamba = {"in_proj": ((EMBED, d), (SSM_INNER, proj_out)),
                 "conv_w": ((CONV, s.conv_width), (SSM_INNER, conv_dim)),
                 "conv_b": ((SSM_INNER, conv_dim),),
                 "dt_bias": ((HEADS, heads),), "A_log": ((HEADS, heads),),
                 "D": ((HEADS, heads),), "norm": ((SSM_INNER, d_inner),),
                 "out_proj": ((SSM_INNER, d_inner), (EMBED, d))}
    norm = ((EMBED, d),)

    def stacked(tree, n):
        return tree_map(lambda dims: ((LAYERS, n), *dims), tree)

    embed = {"embedding": ((VOCAB, cfg.vocab_size), (EMBED, d))}
    if not cfg.tie_embeddings:
        embed["unembed"] = ((EMBED, d), (VOCAB, cfg.vocab_size))
    if cfg.encoder is not None:
        enc = {"norm1": norm, "attn": attn, "norm2": norm,
               "mlp": mlp(cfg.d_ff)}
        dec = {"norm1": norm, "self_attn": attn, "norm_x": norm,
               "cross_attn": attn, "norm2": norm, "mlp": mlp(cfg.d_ff)}
        return {"embed": embed,
                "src_proj": ((None, cfg.encoder.d_source), (EMBED, d)),
                "enc": stacked(enc, cfg.encoder.num_layers),
                "dec": stacked(dec, cfg.num_layers),
                "enc_norm": norm, "final_norm": norm}
    mixers = {"attn": attn, "mamba": mamba}
    mlps = {"dense": mlp(cfg.d_ff), "moe": moe}
    blocks = {}
    for i, spec in enumerate(cfg.pattern):
        block = {"norm1": norm, "mixer": mixers[spec.mixer]}
        if spec.mlp != "none":
            block["norm2"] = norm
            block["mlp"] = mlps[spec.mlp]
        blocks[f"pos{i}"] = stacked(block, cfg.pattern_repeats)
    layout = {"embed": embed, "blocks": blocks, "final_norm": norm}
    if cfg.vision is not None:
        layout["patch_proj"] = ((None, cfg.vision.d_patch), (EMBED, d))
    return layout


def tree_axes_flatten(params: ParamTree, axes: AxisTree, prefix=()) -> list:
    """-> [(path, leaf, axes)] in the tree's order."""
    if isinstance(params, dict):
        return [x for k in params
                for x in tree_axes_flatten(params[k], axes[k], prefix + (k,))]
    return [(prefix, params, axes)]


def param_axes(cfg) -> AxisTree:
    """The logical axes of every leaf of ``init_model(cfg)``, as the
    reference's ``init_model`` returns them: layer leaves carry
    ``LAYERS`` first.  Attention and Mamba mixers, dense and MoE MLPs
    (with the MoE's ``shared`` MLP), the VLM's ``patch_proj`` and the
    encoder-decoder's tree, as the reference's ``init_*``."""
    return tree_map(lambda dims: tuple(a for a, _ in dims), _layout(cfg))


def param_shapes(cfg):
    """The shape of every leaf of ``init_model(cfg)`` (a tree of int
    tuples beside ``param_axes``), computed without drawing anything:
    the dry-run's meta trees are built from it."""
    return tree_map(lambda dims: tuple(n for _, n in dims), _layout(cfg))


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
