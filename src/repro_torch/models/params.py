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
LAYERS = "layers"       # stacked layer axis
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

_MAMBA_AXES = {
    "in_proj": (EMBED, SSM_INNER), "conv_w": (CONV, SSM_INNER),
    "conv_b": (SSM_INNER,), "dt_bias": (HEADS,), "A_log": (HEADS,),
    "D": (HEADS,), "norm": (SSM_INNER,), "out_proj": (SSM_INNER, EMBED)}


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


def param_axes(cfg) -> AxisTree:
    """The logical axes of every leaf of ``init_model(cfg)``, as the
    reference's ``init_model`` returns them: layer leaves carry
    ``LAYERS`` first.  Attention and Mamba mixers, dense and MoE MLPs
    (with the MoE's ``shared`` MLP), the VLM's ``patch_proj`` and the
    encoder-decoder's tree, as the reference's ``init_*``."""
    attn = {"wq": (EMBED, HEADS, HEAD_DIM), "wk": (EMBED, KV_HEADS, HEAD_DIM),
            "wv": (EMBED, KV_HEADS, HEAD_DIM), "wo": (HEADS, HEAD_DIM, EMBED)}
    if cfg.qk_norm:
        attn["q_norm"] = (HEAD_DIM,)
        attn["k_norm"] = (HEAD_DIM,)
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp = {"w_gate": (EMBED, MLP), "w_up": (EMBED, MLP),
               "w_down": (MLP, EMBED)}
    else:
        mlp = {"w_up": (EMBED, MLP), "w_down": (MLP, EMBED)}
    moe = None
    if cfg.moe is not None:
        moe = {"router": (EMBED, EXPERT),
               "w_gate": (EXPERT, EMBED, EXPERT_MLP),
               "w_up": (EXPERT, EMBED, EXPERT_MLP),
               "w_down": (EXPERT, EXPERT_MLP, EMBED)}
        if cfg.moe.num_shared > 0:
            moe["shared"] = mlp
    mixers = {"attn": attn, "mamba": _MAMBA_AXES}
    mlps = {"dense": mlp, "moe": moe}
    blocks = {}
    for i, spec in enumerate(cfg.pattern):
        block = {"norm1": (EMBED,), "mixer": mixers[spec.mixer]}
        if spec.mlp != "none":
            block["norm2"] = (EMBED,)
            block["mlp"] = mlps[spec.mlp]
        blocks[f"pos{i}"] = tree_map(lambda ax: (LAYERS, *ax), block)
    embed = {"embedding": (VOCAB, EMBED)}
    if not cfg.tie_embeddings:
        embed["unembed"] = (EMBED, VOCAB)
    if cfg.encoder is not None:
        enc = {"norm1": (EMBED,), "attn": attn, "norm2": (EMBED,),
               "mlp": mlp}
        dec = {"norm1": (EMBED,), "self_attn": attn, "norm_x": (EMBED,),
               "cross_attn": attn, "norm2": (EMBED,), "mlp": mlp}
        return {"embed": embed, "src_proj": (None, EMBED),
                "enc": tree_map(lambda ax: (LAYERS, *ax), enc),
                "dec": tree_map(lambda ax: (LAYERS, *ax), dec),
                "enc_norm": (EMBED,), "final_norm": (EMBED,)}
    axes = {"embed": embed, "blocks": blocks, "final_norm": (EMBED,)}
    if cfg.vision is not None:
        axes["patch_proj"] = (None, EMBED)
    return axes


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
