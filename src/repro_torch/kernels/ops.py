"""Dispatch of the kernels by the device of their tensors.

A CPU tensor goes to the plain version in ``ref.py``.  A CUDA tensor
goes to the hand-written kernel, which launches or raises: nothing falls
back.  The model calls the attention entries, ``ssd_scan`` and
``expert_gemm`` when ``cfg.attn_impl == 'pallas'``; k-means calls
``router_assign``.
"""
from __future__ import annotations

import torch

from . import ref


def _device_type(t) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return kind


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B, S, H, D); k, v: (B, S, KH, D) -> (B, S, H, D).

    Differentiable: where an input requires a gradient it goes through
    ``flash_attention_trainable``; otherwise (serving, scoring) through
    the forward kernel alone."""
    kind = _device_type(q)
    if _needs_grad(q, k, v):
        return flash_attention_trainable(q, k, v, causal=causal,
                                         window=window)
    if kind == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    from .flash_attention import flash_attention as kernel
    return kernel(q, k, v, causal=causal, window=window)


def flash_attention_trainable(q, k, v, *, causal=True, window=None):
    """Flash attention as a ``torch.autograd.Function``: the forward that
    keeps the LSE rows, and the dK/dV and dQ kernels as its backward."""
    from .flash_attention_bwd import FlashAttention
    _device_type(q)
    return FlashAttention.apply(q, k, v, causal, window)


def fwd_with_lse(q, k, v, *, causal=True, window=None):
    """-> (o (B,S,H,D), lse (B,H,S) f32)."""
    if _device_type(q) == "cpu":
        return ref.fwd_with_lse_ref(q, k, v, causal=causal, window=window)
    from .flash_attention_bwd import flash_attention_lse
    return flash_attention_lse(q, k, v, causal=causal, window=window)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None):
    """-> (dq, dk, dv) in q's dtype."""
    if _device_type(q) == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window)
    from .flash_attention_bwd import (attention_delta, flash_attention_dkv,
                                      flash_attention_dq)
    delta = attention_delta(do, o)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal=causal,
                                 window=window)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal=causal,
                            window=window)
    return dq, dk, dv


def decode_attention(q, k_cache, v_cache, cache_index, *, window=None,
                     k_scale=None, v_scale=None):
    """Flash-decode: single-token GQA attention over the ring KV cache.
    q: (B, H, D); caches (B, T, KH, D); cache_index (B,) int32."""
    if _device_type(q) == "cpu":
        return ref.flash_decode_ref(q, k_cache, v_cache, cache_index,
                                    window=window, k_scale=k_scale,
                                    v_scale=v_scale)
    from .decode_attention import flash_decode as kernel
    return kernel(q, k_cache, v_cache, cache_index, window=window,
                  k_scale=k_scale, v_scale=v_scale)


def router_assign(z, centroids):
    """Eq. 1: z (N, D), centroids (K, D) -> (assign (N,) int32, min d2
    (N,) f32), ties to the first centroid."""
    if _device_type(z) == "cpu":
        return ref.router_assign_ref(z, centroids)
    from .router_assign import router_assign as kernel
    return kernel(z.contiguous(), centroids.contiguous())


def _no_backward(name: str, *ts) -> None:
    if _needs_grad(*ts):
        raise NotImplementedError(
            f"{name} has no backward kernel yet: a CUDA input that requires "
            f"a gradient would get an output without one (use the plain "
            f"path, attn_impl != 'pallas', to differentiate)")


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int):
    """Mamba2 SSD chunked scan.  x (B,S,H,P), dt (B,S,H), a (H,),
    bmat/cmat (B,S,G,N) with H % G == 0 and S % chunk == 0 -> (y
    (B,S,H,P) in x's dtype, final state (B,H,P,N) f32).  Forward only:
    a CUDA input that requires a gradient raises."""
    if _device_type(x) == "cpu":
        return ref.ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    _no_backward("ssd_scan", x, dt, a, bmat, cmat)
    from .ssd_scan import ssd_scan as kernel
    return kernel(x.contiguous(), dt.float().contiguous(),
                  a.float().contiguous(), bmat.contiguous(),
                  cmat.contiguous(), chunk=chunk)


def expert_gemm(xe, w):
    """Per-expert batched GEMM: xe (E, C, d) @ w (E, d, f) -> (E, C, f) in
    xe's dtype, f32 accumulation.  Forward only: a CUDA input that
    requires a gradient raises."""
    if _device_type(xe) == "cpu":
        return ref.expert_gemm_ref(xe, w)
    _no_backward("expert_gemm", xe, w)
    from .moe_gmm import expert_gemm as kernel
    return kernel(xe.contiguous(), w.contiguous())
