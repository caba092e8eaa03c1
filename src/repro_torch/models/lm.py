"""Stacked-block decoder language model (dense attention blocks).

The port of ``repro/models/lm.py``.  Parameters of each pattern
position are stacked across repeats under ``blocks/pos{i}`` with the
layer axis first, as in the reference; a Python loop walks the stack
where the reference uses ``lax.scan``.  Decode caches are stacked the
same way and written in place.  MoE and Mamba blocks are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .layers import (_cache_positions, apply_attention, apply_mlp,
                     embed_tokens, init_attention, init_embedding, init_mlp,
                     init_rmsnorm, rms_norm, torch_dtype, unembed)
from .params import cast_tree, tree_map


def _check_block(spec) -> None:
    if spec.mixer != "attn" or spec.mlp not in ("dense", "none"):
        raise NotImplementedError(
            f"block {spec} is not ported to repro_torch yet: only dense "
            f"attention blocks (ROADMAP queue 1, item 4: other families)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ModelConfig, spec):
    _check_block(spec)
    p = {"norm1": init_rmsnorm(gen, cfg.d_model),
         "mixer": init_attention(gen, cfg)}
    if spec.mlp != "none":
        p["norm2"] = init_rmsnorm(gen, cfg.d_model)
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_lm(gen: torch.Generator, cfg: ModelConfig):
    """Parameters on ``gen.device``, with the reference tree's keys,
    shapes and dtypes (random values from ``gen``, not ``jax.random``)."""
    if cfg.vision is not None:
        raise NotImplementedError("the VLM patch stub is not ported yet")
    reps = cfg.pattern_repeats
    params = {"embed": init_embedding(gen, cfg)}
    params["blocks"] = {
        f"pos{i}": _stack([_init_block(gen, cfg, spec) for _ in range(reps)])
        for i, spec in enumerate(cfg.pattern)}
    params["final_norm"] = init_rmsnorm(gen, cfg.d_model)
    return cast_tree(params, torch_dtype(cfg.dtype))


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------
def _apply_block(bp, cfg: ModelConfig, spec, x, *, positions, window,
                 cache=None, cache_index=None):
    _check_block(spec)
    h = rms_norm(bp["norm1"], x, cfg.norm_eps)
    y, _ = apply_attention(bp["mixer"], cfg, h, positions=positions,
                           causal=True, window=window, cache=cache,
                           cache_index=cache_index)
    x = x + y
    if spec.mlp != "none":
        h = rms_norm(bp["norm2"], x, cfg.norm_eps)
        x = x + apply_mlp(bp["mlp"], cfg, h)
    return x


def _scan_blocks(params, cfg: ModelConfig, x, *, positions, window,
                 caches=None, cache_index=None):
    """Walk the repeating pattern group over ``pattern_repeats``; each
    layer's cache is a view into the stacked cache, written in place."""
    for r in range(cfg.pattern_repeats):
        for i, spec in enumerate(cfg.pattern):
            bp = tree_map(lambda a, r=r: a[r], params["blocks"][f"pos{i}"])
            c = None if caches is None else \
                {k: a[r] for k, a in caches[f"pos{i}"].items()}
            x = _apply_block(bp, cfg, spec, x, positions=positions,
                             window=window, cache=c, cache_index=cache_index)
    return x


def apply_lm(params, cfg: ModelConfig, tokens, *, window=None,
             return_hidden=False):
    """Training / scoring forward.  tokens: (B, S) -> (logits (B, S, V),
    aux) — aux is 0 for dense blocks."""
    b, s = tokens.shape
    x = embed_tokens(params["embed"], cfg, tokens)
    positions = torch.arange(s, device=x.device)[None, :]
    window = window if window is not None else cfg.sliding_window
    x = _scan_blocks(params, cfg, x, positions=positions, window=window)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), device=x.device)
    if return_hidden:
        return x, aux
    return unembed(params["embed"], cfg, x), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, *, device="cuda"):
    """Stacked caches matching the parameter layout (layer axis first)."""
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    reps = cfg.pattern_repeats
    shape = (reps, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        _check_block(spec)
        if cfg.kv_quant:
            c = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "k_scale": torch.zeros(shape[:-1], device=dev),
                 "v_scale": torch.zeros(shape[:-1], device=dev)}
        else:
            c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        caches[f"pos{i}"] = c
    return caches


def decode_step(params, cfg: ModelConfig, tokens, caches, cache_index, *,
                window=None):
    """One decode step.  tokens: (B, 1) -> (logits (B,1,V), caches).

    cache_index: a scalar, or a (B,) vector when the batch rows sit at
    different sequence positions.  ``caches`` is updated in place and
    returned.
    """
    x = embed_tokens(params["embed"], cfg, tokens)
    ci = _cache_positions(cache_index, tokens.shape[0], x.device)
    window = window if window is not None else cfg.sliding_window
    x = _scan_blocks(params, cfg, x, positions=ci[:, None], window=window,
                     caches=caches, cache_index=ci)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], cfg, x), caches


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            window=None):
    """Single-pass prompt ingestion: forward ``tokens`` once, writing the
    KV decode caches at positions 0..S-1 (the dense masked branch, as in
    the reference).  Returns (logits (B,S,V), caches) ready for
    ``decode_step`` at ``cache_index = S``."""
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt length {s} exceeds cache_len {cache_len}")
    caches = init_decode_cache(cfg, b, cache_len, device=tokens.device)
    x = embed_tokens(params["embed"], cfg, tokens)
    positions = torch.arange(s, device=x.device)[None, :]
    window = window if window is not None else cfg.sliding_window
    x = _scan_blocks(params, cfg, x, positions=positions, window=window,
                     caches=caches, cache_index=0)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], cfg, x), caches


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(logits, tokens, prefix_len: int = 0):
    """Per-token NLL + mask, excluding the routing prefix (paper §2.4)."""
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, targets[..., None])[..., 0] - logz
    pos = torch.arange(targets.shape[1], device=lg.device)[None, :]
    mask = (pos + 1 >= prefix_len).expand(targets.shape).float()
    return -(ll * mask), mask


def lm_loss_mean(logits, tokens, prefix_len: int = 0):
    nll, mask = lm_loss(logits, tokens, prefix_len)
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
