"""Whisper-style encoder-decoder backbone.

The port of ``repro/models/encdec.py``.  The mel/conv frontend is a
stub, as in the reference: the caller supplies frame embeddings (B,
T_src, d_source); this module holds the transformer encoder that
consumes them and the causal decoder with cross-attention.  Encoder and
decoder layers are stacked with the layer axis first under ``enc`` and
``dec``; a Python loop walks the stack where the reference uses
``lax.scan``.  The decoder's self-attention cache is written in place;
each layer owns its own buffer.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from .config import ModelConfig
from .layers import (_cache_positions, apply_attention, apply_mlp,
                     attention_kv, attention_out, attention_q, embed_tokens,
                     full_attention, init_attention, init_embedding,
                     init_mlp, init_rmsnorm, rms_norm, torch_dtype, unembed)
from .params import cast_tree, tree_map


def _sinusoidal(positions, dim: int):
    """(S,) positions -> (S, dim) f32: sines then cosines, the
    reference's ``max(half - 1, 1)`` denominator."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _stack_layers(gen: torch.Generator, n: int, init_one, dtype):
    """n layers drawn one after another, stacked (layer axis first) and
    cast to ``dtype``: every layer is its own memory."""
    layers = [init_one(gen) for _ in range(n)]
    return cast_tree(tree_map(lambda *xs: torch.stack(xs), *layers), dtype)


def init_encdec(gen: torch.Generator, cfg: ModelConfig):
    """Parameters on ``gen.device`` with the reference tree's keys, shapes
    and dtypes (random values from ``gen``, not ``jax.random``)."""
    enc = cfg.encoder
    d = cfg.d_model
    dtype = torch_dtype(cfg.dtype)

    def enc_layer(g):
        return {"norm1": init_rmsnorm(g, d), "attn": init_attention(g, cfg),
                "norm2": init_rmsnorm(g, d), "mlp": init_mlp(g, cfg)}

    def dec_layer(g):
        return {"norm1": init_rmsnorm(g, d),
                "self_attn": init_attention(g, cfg),
                "norm_x": init_rmsnorm(g, d),
                "cross_attn": init_attention(g, cfg),
                "norm2": init_rmsnorm(g, d), "mlp": init_mlp(g, cfg)}

    params = {"embed": cast_tree(init_embedding(gen, cfg), dtype)}
    params["src_proj"] = torch.randn(
        (enc.d_source, d), generator=gen, device=gen.device).div_(
        math.sqrt(enc.d_source)).to(dtype)
    params["enc"] = _stack_layers(gen, enc.num_layers, enc_layer, dtype)
    params["dec"] = _stack_layers(gen, cfg.num_layers, dec_layer, dtype)
    params["enc_norm"] = init_rmsnorm(gen, d).to(dtype)
    params["final_norm"] = init_rmsnorm(gen, d).to(dtype)
    return params


def _layers(stack, n: int):
    """The stacked tree's n layers as views."""
    return [tree_map(lambda a, i=i: a[i], stack) for i in range(n)]


def _run(body, h, lps, remat: bool):
    """h through ``body(h, lp)`` for each layer; with ``remat`` (and
    gradients on) each layer runs under ``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` of its scan body (nothing saved)."""
    remat = remat and torch.is_grad_enabled()
    for lp in lps:
        h = checkpoint(body, h, lp, use_reentrant=False) if remat \
            else body(h, lp)
    return h


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, T, d_source) stub embeddings -> (B, T, d_model)."""
    dtype = torch_dtype(cfg.dtype)
    x = frames.to(dtype) @ params["src_proj"].to(dtype)
    pos = torch.arange(frames.shape[1], device=x.device)
    x = x + _sinusoidal(pos, cfg.d_model)[None].to(x.dtype)
    positions = pos[None, :]

    def body(h, lp):
        y, _ = apply_attention(lp["attn"], cfg,
                               rms_norm(lp["norm1"], h, cfg.norm_eps),
                               positions=positions, causal=False)
        h = h + y
        return h + apply_mlp(lp["mlp"], cfg,
                             rms_norm(lp["norm2"], h, cfg.norm_eps))

    x = _run(body, x, _layers(params["enc"], cfg.encoder.num_layers),
             cfg.remat)
    return rms_norm(params["enc_norm"], x, cfg.norm_eps)


def _cross_attn_cached(lp, cfg: ModelConfig, h, cross_kv):
    """Cross-attention against the encoder K/V precomputed by
    ``build_cross_cache`` (one layer's (B, T_src, KH, D) slices)."""
    p = lp["cross_attn"]
    q = attention_q(p, cfg, h)
    out = full_attention(q, cross_kv["k"].to(q.dtype),
                         cross_kv["v"].to(q.dtype), causal=False,
                         window=None)
    return attention_out(p, out)


def _dec_block(lp, cfg: ModelConfig, h, enc_out, positions, window, cache,
               cache_index, cross_kv=None):
    y, _ = apply_attention(
        lp["self_attn"], cfg, rms_norm(lp["norm1"], h, cfg.norm_eps),
        positions=positions, causal=True, window=window, cache=cache,
        cache_index=cache_index)
    h = h + y
    hx = rms_norm(lp["norm_x"], h, cfg.norm_eps)
    if cross_kv is not None:
        y = _cross_attn_cached(lp, cfg, hx, cross_kv)
    else:
        y, _ = apply_attention(lp["cross_attn"], cfg, hx,
                               positions=positions, kv_x=enc_out)
    h = h + y
    return h + apply_mlp(lp["mlp"], cfg,
                         rms_norm(lp["norm2"], h, cfg.norm_eps))


def apply_encdec(params, cfg: ModelConfig, tokens, frames, *, window=None):
    """Training forward: (B,S) tokens + (B,T,d_source) frames -> (logits
    (B,S,V), aux 0)."""
    enc_out = encode(params, cfg, frames)
    x = embed_tokens(params["embed"], cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    window = window if window is not None else cfg.sliding_window

    def body(h, lp):
        return _dec_block(lp, cfg, h, enc_out, positions, window, None,
                          None)

    x = _run(body, x, _layers(params["dec"], cfg.num_layers), cfg.remat)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], cfg, x), torch.zeros((), device=x.device)


def init_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device="cuda"):
    """The decoder's self-attention KV cache, (L, B, T, KH, D) each.  One
    zero buffer per leaf with the layer axis first: every layer's slice
    is its own memory (the reference broadcasts one zero buffer, which
    its functional updates copy; written in place, a broadcast view would
    make every layer write into the same slots)."""
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def build_cross_cache(params, cfg: ModelConfig, enc_out):
    """Per-layer cross-attention K/V from the encoder output, computed
    once per request: {"k", "v"} of (L, B, T_src, KH, D)."""
    ks, vs = [], []
    for lp in _layers(params["dec"], cfg.num_layers):
        k, v = attention_kv(lp["cross_attn"], cfg, enc_out)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step_encdec(params, cfg: ModelConfig, tokens, enc_out, caches,
                       cache_index, *, window=None, cross_kv=None):
    """One decoder step: tokens (B, 1) -> (logits (B,1,V), caches).  The
    self-attention cache is written in place (flash-decode reads it under
    ``attn_impl="pallas"``); the cross-attention reads ``cross_kv`` if
    given, else recomputes K/V from ``enc_out``.  cache_index is a scalar
    or a (B,) vector."""
    x = embed_tokens(params["embed"], cfg, tokens)
    positions = _cache_positions(cache_index, tokens.shape[0],
                                 x.device)[:, None]
    window = window if window is not None else cfg.sliding_window
    for i, lp in enumerate(_layers(params["dec"], cfg.num_layers)):
        cache = {n: a[i] for n, a in caches.items()}
        ckv = None if cross_kv is None else \
            {n: a[i] for n, a in cross_kv.items()}
        x = _dec_block(lp, cfg, x, enc_out, positions, window, cache,
                       cache_index, cross_kv=ckv)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], cfg, x), caches
