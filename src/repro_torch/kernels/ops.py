"""Dispatch of the attention kernels by the device of their tensors.

A CPU tensor goes to the plain version in ``ref.py``.  A CUDA tensor
goes to the hand-written kernel, which launches or raises: nothing falls
back.  The model calls these when ``cfg.attn_impl == 'pallas'``.
"""
from __future__ import annotations

from . import ref


def _device_type(t) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {t.device}")
    return kind


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B, S, H, D); k, v: (B, S, KH, D) -> (B, S, H, D)."""
    if _device_type(q) == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    from .flash_attention import flash_attention as kernel
    return kernel(q, k, v, causal=causal, window=window)


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
