"""Dispatch of the kernels by the device of their tensors.

A CPU tensor goes to the plain version in ``ref.py``, and so does a meta
tensor (the dry-run's shapes).  A CUDA tensor goes to the hand-written
kernel, which launches or raises: nothing falls back.  The model calls
the attention entries, ``ssd_scan`` and ``expert_gemm`` when
``cfg.attn_impl == 'pallas'``; k-means calls ``router_assign``.

Where an input requires a gradient, ``flash_attention``, ``ssd_scan`` and
``expert_gemm`` go through their autograd Functions (``FlashAttention``,
``SSDScan``, ``ExpertGemm``) on both devices: on the card the forward
kernel that keeps what the backward needs, and the backward kernels
(dK/dV and dQ; ``ssd_scan_bwd``; ``expert_gemm_dx`` and
``expert_gemm_dw``); on the CPU the plain forward and plain backward.
Serving (no gradient) launches the forward kernel alone.
"""
from __future__ import annotations

import torch

from . import ref


def _device_type(t) -> str:
    """-> "cuda" (the kernel) or "cpu" (the plain version).  A meta
    tensor (the dry-run's, ``launch/dryrun.py``) takes the plain version
    as a CPU one does: that is shape propagation, not a fallback, since
    a meta tensor holds no data for a kernel to read."""
    kind = t.device.type
    if kind == "meta":
        return "cpu"
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


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int):
    """Mamba2 SSD chunked scan.  x (B,S,H,P), dt (B,S,H), a (H,),
    bmat/cmat (B,S,G,N) with H % G == 0 and S % chunk == 0 -> (y
    (B,S,H,P) in x's dtype, final state (B,H,P,N) f32).  Differentiable:
    where an input requires a gradient it goes through ``SSDScan``."""
    kind = _device_type(x)
    if _needs_grad(x, dt, a, bmat, cmat):
        from .ssd_scan import SSDScan
        return SSDScan.apply(x, dt, a, bmat, cmat, chunk)
    if kind == "cpu":
        return ref.ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    from .ssd_scan import ssd_scan as kernel
    return kernel(x.contiguous(), dt.float().contiguous(),
                  a.float().contiguous(), bmat.contiguous(),
                  cmat.contiguous(), chunk=chunk)


def ssd_scan_fwd_states(x, dt, a, bmat, cmat, *, chunk: int):
    """-> (y, final state, start states (B,S/chunk,H,P,N) f32 on the
    card; None on the CPU, whose plain backward recomputes them)."""
    if _device_type(x) == "cpu":
        return (*ref.ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk), None)
    from .ssd_scan import ssd_scan as kernel
    return kernel(x, dt, a, bmat, cmat, chunk=chunk, states=True)


def ssd_scan_bwd(x, dt, a, bmat, cmat, dy, dstate, starts, *, chunk: int):
    """-> (dx, ddt, da, dB, dC); dstate (the final state's gradient) may
    be None."""
    if _device_type(x) == "cpu":
        return ref.ssd_scan_bwd_ref(x, dt, a, bmat, cmat, dy, dstate,
                                    chunk=chunk)
    from .ssd_scan import ssd_scan_bwd as kernel
    return kernel(x, dt, a, bmat, cmat, dy, dstate, starts, chunk=chunk)


def expert_gemm(xe, w):
    """Per-expert batched GEMM: xe (E, C, d) @ w (E, d, f) -> (E, C, f) in
    xe's dtype, f32 accumulation.  Differentiable: where an input
    requires a gradient it goes through ``ExpertGemm``."""
    _device_type(xe)
    if _needs_grad(xe, w):
        from .moe_gmm import ExpertGemm
        return ExpertGemm.apply(xe, w)
    return expert_gemm_fwd(xe, w)


def expert_gemm_fwd(xe, w):
    if _device_type(xe) == "cpu":
        return ref.expert_gemm_ref(xe, w)
    from .moe_gmm import expert_gemm as kernel
    return kernel(xe.contiguous(), w.contiguous())


def expert_gemm_bwd(xe, w, dy, *, need_dx=True, need_dw=True):
    """-> (dx (E,C,d) or None, dw (E,d,f) or None) for dy (E,C,f)."""
    if _device_type(xe) == "cpu":
        dx, dw = ref.expert_gemm_bwd_ref(xe, w, dy)
    else:
        from .moe_gmm import expert_gemm_dw, expert_gemm_dx
        dx = expert_gemm_dx(dy, w, xe) if need_dx else None
        dw = expert_gemm_dw(xe, dy, w) if need_dw else None
    return (dx if need_dx else None), (dw if need_dw else None)
