"""Stacked-block decoder language model: dense, token-MoE, Mamba2 and
hybrid blocks, and the VLM patch-embedding stub.

The port of ``repro/models/lm.py``.  Parameters of each pattern
position are stacked across repeats under ``blocks/pos{i}`` with the
layer axis first, as in the reference; a Python loop walks the stack
where the reference uses ``lax.scan``.  Decode caches (KV for attention,
conv and SSM state for Mamba) are stacked the same way and written in
place.  A VLM config (``cfg.vision``) adds ``patch_proj``, and
``apply_lm`` / ``prefill`` take precomputed patch embeddings that
overwrite the first positions of the sequence.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.device import resolve_device

from .config import ModelConfig
from .layers import (_cache_positions, apply_attention, apply_mlp,
                     attention_out, attention_qkv, cached_attention,
                     embed_tokens, init_attention, init_embedding, init_mlp,
                     init_rmsnorm, rms_norm, torch_dtype, unembed)
from .moe_layer import apply_moe, init_moe
from .params import cast_tree, tree_map
from .ssm import apply_mamba, init_mamba, init_ssm_state


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ModelConfig, spec):
    p = {"norm1": init_rmsnorm(gen, cfg.d_model)}
    if spec.mixer == "attn":
        p["mixer"] = init_attention(gen, cfg)
    elif spec.mixer == "mamba":
        p["mixer"] = init_mamba(gen, cfg)
    else:
        raise ValueError(spec.mixer)
    if spec.mlp != "none":
        p["norm2"] = init_rmsnorm(gen, cfg.d_model)
        if spec.mlp == "dense":
            p["mlp"] = init_mlp(gen, cfg)
        elif spec.mlp == "moe":
            p["mlp"] = init_moe(gen, cfg)
        else:
            raise ValueError(spec.mlp)
    return p


def _init_stacked(gen: torch.Generator, cfg: ModelConfig, spec, dtype):
    """One pattern position's leaves for all repeats, drawn layer by layer
    (f32) and cast into a stack preallocated in ``dtype``: the f32 copy
    of the whole stack never exists."""
    reps = cfg.pattern_repeats
    stacked = None
    for r in range(reps):
        layer = _init_block(gen, cfg, spec)
        if stacked is None:
            stacked = tree_map(lambda a: torch.empty(
                (reps, *a.shape), device=a.device,
                dtype=dtype if a.is_floating_point() else a.dtype), layer)
        tree_map(lambda dst, src, r=r: dst[r].copy_(src), stacked, layer)
        del layer
    return stacked


def init_lm(gen: torch.Generator, cfg: ModelConfig):
    """Parameters on ``gen.device``, with the reference tree's keys,
    shapes and dtypes (random values from ``gen``, not ``jax.random``).
    Each leaf is cast to ``cfg.dtype`` as it is drawn."""
    dtype = torch_dtype(cfg.dtype)
    params = {"embed": cast_tree(init_embedding(gen, cfg), dtype)}
    params["blocks"] = {f"pos{i}": _init_stacked(gen, cfg, spec, dtype)
                        for i, spec in enumerate(cfg.pattern)}
    params["final_norm"] = init_rmsnorm(gen, cfg.d_model).to(dtype)
    if cfg.vision is not None:
        d_patch = cfg.vision.d_patch
        params["patch_proj"] = torch.randn(
            (d_patch, cfg.d_model), generator=gen, device=gen.device).div_(
            math.sqrt(d_patch)).to(dtype)
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------
def _write_state_(cache, new_state, mask=None) -> None:
    """Overwrite a Mamba layer's cache views in place; where ``mask`` (B,)
    is False a row keeps its old state bit for bit."""
    for k, v in new_state.items():
        v = v.to(cache[k].dtype)
        if mask is not None:
            v = torch.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                            cache[k])
        cache[k].copy_(v)


def _apply_block(bp, cfg: ModelConfig, spec, x, *, positions, window,
                 cache=None, cache_index=None, is_prefill=False, mask=None):
    """-> (x, aux): aux is the MoE load-balance loss, None without one."""
    h = rms_norm(bp["norm1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        y, _ = apply_attention(bp["mixer"], cfg, h, positions=positions,
                               causal=True, window=window, cache=cache,
                               cache_index=cache_index, mask=mask)
    elif cache is None:
        y, _ = apply_mamba(bp["mixer"], cfg, h)
    else:
        # decode continues from the cached state; prefill scans the full
        # sequence from a zero state and overwrites the incoming (stale)
        # slot state, matching the attention branch's write-from-
        # position-0 semantics
        y, new_state = apply_mamba(bp["mixer"], cfg, h,
                                   state=None if is_prefill else cache,
                                   return_state=is_prefill)
        _write_state_(cache, new_state, mask)
    x = x + y
    aux = None
    if spec.mlp != "none":
        h = rms_norm(bp["norm2"], x, cfg.norm_eps)
        if spec.mlp == "moe":
            y, aux = apply_moe(bp["mlp"], cfg, h)
        else:
            y = apply_mlp(bp["mlp"], cfg, h)
        x = x + y
    return x, aux


def _apply_group(group, cfg: ModelConfig, x, aux, *, positions, window,
                 caches=None, cache_index=None, is_prefill=False,
                 mask=None):
    """One pass over ``cfg.pattern`` (the reference's scan body): group
    and caches hold one layer's leaves per pattern position.  -> (x, aux
    plus the group's MoE load-balance losses)."""
    for i, spec in enumerate(cfg.pattern):
        c = None if caches is None else caches[f"pos{i}"]
        x, a = _apply_block(group[f"pos{i}"], cfg, spec, x,
                            positions=positions, window=window, cache=c,
                            cache_index=cache_index, is_prefill=is_prefill,
                            mask=mask)
        if a is not None:
            aux = aux + a
    return x, aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the weight products' outputs (what
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps:
    ``x @ w`` reaches the dispatcher as ``mm`` or ``addmm``), recompute
    the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _scan_blocks(params, cfg: ModelConfig, x, *, positions, window,
                 caches=None, cache_index=None, is_prefill=False,
                 mask=None):
    """Walk the repeating pattern group over ``pattern_repeats``; each
    layer's cache is a view into the stacked cache, written in place.

    With ``cfg.remat``, a cache-free forward that records gradients runs
    each layer group under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of its scan body): the backward recomputes the
    group from its input, saving nothing (``remat_policy="full"``) or
    the weight products (``"dots"``).  Prefill, decode and calls without
    gradients run as they are.  -> (x, aux summed over the MoE blocks,
    f32)."""
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _save_dots)
                  if cfg.remat_policy == "dots" else noop_context_fn)
    for r in range(cfg.pattern_repeats):
        group = {k: tree_map(lambda a, r=r: a[r], v)
                 for k, v in params["blocks"].items()}
        c = None if caches is None else \
            {k: {n: a[r] for n, a in v.items()} for k, v in caches.items()}
        kw = dict(positions=positions, window=window, caches=c,
                  cache_index=cache_index, is_prefill=is_prefill, mask=mask)
        if remat:
            x, aux = checkpoint(_apply_group, group, cfg, x, aux,
                                use_reentrant=False, context_fn=context_fn,
                                **kw)
        else:
            x, aux = _apply_group(group, cfg, x, aux, **kw)
    return x, aux


def _embed_inputs(params, cfg: ModelConfig, tokens, patch_embeds=None):
    """Token embeddings; for a VLM, ``patch_embeds`` (B, P, d_patch) @
    ``patch_proj`` replace the first P positions (the reference's
    ``dynamic_update_slice`` at 0, which needs S >= P)."""
    x = embed_tokens(params["embed"], cfg, tokens)
    if cfg.vision is None or patch_embeds is None:
        return x
    n = patch_embeds.shape[1]
    if n > x.shape[1]:
        raise ValueError(f"{n} patch positions do not fit a sequence of "
                         f"{x.shape[1]} tokens")
    proj = patch_embeds.to(x.dtype) @ params["patch_proj"].to(x.dtype)
    return torch.cat([proj, x[:, n:]], dim=1)


def apply_lm(params, cfg: ModelConfig, tokens, *, patch_embeds=None,
             window=None, return_hidden=False):
    """Training / scoring forward.  tokens: (B, S) -> (logits (B, S, V),
    aux) — aux is the summed MoE load-balance loss (0 without MoE)."""
    b, s = tokens.shape
    x = _embed_inputs(params, cfg, tokens, patch_embeds)
    positions = torch.arange(s, device=x.device)[None, :]
    window = window if window is not None else cfg.sliding_window
    x, aux = _scan_blocks(params, cfg, x, positions=positions, window=window)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return unembed(params["embed"], cfg, x), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, *, device="cuda"):
    """Stacked caches matching the parameter layout (layer axis first):
    KV for attention, conv (cache dtype) and SSM (f32) state for Mamba."""
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    reps = cfg.pattern_repeats
    shape = (reps, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "mamba":
            c = {k: v[None].repeat(reps, *([1] * v.ndim)) for k, v in
                 init_ssm_state(cfg, batch, dtype, device=dev).items()}
        elif cfg.kv_quant:
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
                window=None, mask=None):
    """One decode step.  tokens: (B, 1) -> (logits (B,1,V), caches).

    cache_index: a scalar, or a (B,) vector when the batch rows sit at
    different sequence positions.  ``caches`` is updated in place and
    returned.  ``mask`` (B,) bool: a row where it is False leaves its
    cache (K, V, int8 scales, Mamba conv and SSM state) bit for bit
    unchanged, as the reference's masked decode does; its logits are
    meaningless.  The select runs on the device: no host sync, so the
    step can be captured in a CUDA graph.
    """
    x = embed_tokens(params["embed"], cfg, tokens)
    ci = _cache_positions(cache_index, tokens.shape[0], x.device)
    window = window if window is not None else cfg.sliding_window
    x, _ = _scan_blocks(params, cfg, x, positions=ci[:, None],
                        window=window, caches=caches, cache_index=ci,
                        mask=mask)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], cfg, x), caches


# ---------------------------------------------------------------------------
# Path-stacked decode (the continuous engine's stacked-island tick)
# ---------------------------------------------------------------------------
def stack_paths(path_params_list):
    """Stack P homogeneous paths' weights once: block leaves as (reps, P,
    ...), so that each layer's slice (P, ...) is contiguous, the others
    (embedding, final norm) as (P, ...)."""
    def stack(dim):
        return lambda *xs: torch.stack(xs, dim)
    first = path_params_list[0]
    return {k: tree_map(stack(1 if k == "blocks" else 0), first[k],
                        *(p[k] for p in path_params_list[1:]))
            for k in first}


def path_view(stacked, p: int):
    """Path ``p``'s weights as views into the stack (the reference tree's
    layout: block leaves (reps, ...), each layer's slice contiguous)."""
    return {k: tree_map(lambda a: a[:, p] if k == "blocks" else a[p], v)
            for k, v in stacked.items()}


def _paths_loop(fn, bp, x, caches, mask):
    """Apply ``fn(params, x (S,1,d), cache, mask)`` path by path (the
    mixers and MLPs with no batched form over P: Mamba, MoE) and stack the
    (S,1,d) outputs back to (P,S,d)."""
    outs = []
    for p in range(x.shape[0]):
        c = None if caches is None else {n: a[p] for n, a in caches.items()}
        outs.append(fn(tree_map(lambda a, p=p: a[p], bp), x[p][:, None], c,
                       None if mask is None else mask[p])[:, 0])
    return torch.stack(outs)


def decode_step_paths(stacked, cfg: ModelConfig, tokens, caches,
                      cache_index, mask=None, *, window=None):
    """One decode step of P homogeneous paths at once (the counterpart of
    the reference's ``jax.vmap`` of its masked decode over the path axis).

    stacked: ``stack_paths`` weights; tokens (P, S, 1); caches with leaves
    (reps, P, S, ...), updated in place; cache_index and mask (P, S) on
    the device.  The projections, the dense MLP and the unembedding are
    batched products over P; the attention is one ``cached_attention``
    (one flash-decode launch under ``attn_impl="pallas"``) over the P*S
    flattened rows of each layer's contiguous (P, S, T, KH, D) cache.
    Mamba mixers and MoE MLPs run path by path on the same code as
    ``decode_step``.  A False row of ``mask`` keeps its cache bit for bit.
    Returns (logits (P, S, 1, V), caches).
    """
    n_paths, slots = tokens.shape[:2]
    emb = stacked["embed"]
    vocab = emb["embedding"].shape[1]
    dev = emb["embedding"].device
    # one gather from the (P*V, d) table: path p's ids offset by p*V
    offs = torch.arange(n_paths, device=dev)[:, None] * vocab
    x = embed_tokens({"embedding": emb["embedding"].flatten(0, 1)}, cfg,
                     tokens[..., 0].long() + offs)                # (P,S,d)
    ci = _cache_positions(cache_index, n_paths * slots, dev).reshape(
        n_paths, slots)
    window = window if window is not None else cfg.sliding_window
    rows = n_paths * slots
    flat_mask = None if mask is None else mask.reshape(rows)

    def mamba(p, h, c, m):
        y, new_state = apply_mamba(p, cfg, h, state=c)
        _write_state_(c, new_state, m)
        return y

    def moe(p, h, c, m):
        return apply_moe(p, cfg, h)[0]

    for r in range(cfg.pattern_repeats):
        for i, spec in enumerate(cfg.pattern):
            bp = tree_map(lambda a: a[r], stacked["blocks"][f"pos{i}"])
            c = {n: a[r] for n, a in caches[f"pos{i}"].items()}
            # per-path norm scales (P, d) broadcast over the slots
            h = rms_norm(bp["norm1"][:, None], x, cfg.norm_eps)
            if spec.mixer == "attn":
                mp = dict(bp["mixer"])
                if cfg.qk_norm:
                    mp["q_norm"] = mp["q_norm"][:, None, None]
                    mp["k_norm"] = mp["k_norm"][:, None, None]
                q, k, v = attention_qkv(mp, cfg, h, ci)
                out = cached_attention(
                    cfg, *(t.reshape(rows, 1, *t.shape[2:])
                           for t in (q, k, v)),
                    # a view (raises where the layer's slice is not
                    # contiguous): the writes must land in the arena
                    {n: a.view(rows, *a.shape[2:]) for n, a in c.items()},
                    ci.reshape(rows), window=window, mask=flat_mask)
                y = attention_out(mp, out.reshape(n_paths, slots,
                                                  *out.shape[2:]))
            else:
                y = _paths_loop(mamba, bp["mixer"], h, c, mask)
            x = x + y
            if spec.mlp != "none":
                h = rms_norm(bp["norm2"][:, None], x, cfg.norm_eps)
                y = (_paths_loop(moe, bp["mlp"], h, None, mask)
                     if spec.mlp == "moe" else apply_mlp(bp["mlp"], cfg, h))
                x = x + y
    x = rms_norm(stacked["final_norm"][:, None], x, cfg.norm_eps)
    return unembed(emb, cfg, x)[:, :, None], caches


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            window=None, patch_embeds=None):
    """Single-pass prompt ingestion: forward ``tokens`` once, writing the
    KV decode caches at positions 0..S-1 (the dense masked branch, as in
    the reference) and each Mamba layer's state after the last token
    (the full-sequence scan from a zero state).  Returns (logits
    (B,S,V), caches) ready for ``decode_step`` at ``cache_index = S``."""
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt length {s} exceeds cache_len {cache_len}")
    caches = init_decode_cache(cfg, b, cache_len, device=tokens.device)
    x = _embed_inputs(params, cfg, tokens, patch_embeds)
    positions = torch.arange(s, device=x.device)[None, :]
    window = window if window is not None else cfg.sliding_window
    x, _ = _scan_blocks(params, cfg, x, positions=positions, window=window,
                        caches=caches, cache_index=0, is_prefill=True)
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
