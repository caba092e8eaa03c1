"""Plain PyTorch versions of the CUDA kernels: what the CPU runs, and
what ``chip_smoke.py`` holds each kernel against on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """Same semantics as kernels.flash_attention (GQA via head groups)."""
    from repro_torch.models.layers import full_attention
    return full_attention(q, k, v, causal=causal, window=window)


def ring_positions(cache_index: torch.Tensor, T: int) -> torch.Tensor:
    """(B,) positions of the token last written -> (B, T) absolute
    position held by each ring slot (negative: never written)."""
    slot = torch.arange(T, device=cache_index.device)[None, :]
    ci = cache_index.long()[:, None]
    idx_last = ci % T
    return torch.where(slot <= idx_last, ci - idx_last + slot,
                       ci - idx_last - T + slot)


def flash_decode_ref(q, k_cache, v_cache, cache_index, *, window=None,
                     k_scale=None, v_scale=None):
    """Dense version of kernels.decode_attention: single-token GQA over
    a ring cache with per-row positions and optional int8 KV scales."""
    b, h, d = q.shape
    T, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    ci = torch.as_tensor(cache_index, dtype=torch.int32,
                         device=q.device).reshape(b)
    kf = k_cache.float()
    vf = v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
        vf = vf * v_scale.float()[..., None]
    qg = q.reshape(b, kh, g, d).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, kf) / math.sqrt(d)
    abs_pos = ring_positions(ci, T)                         # (B, T)
    valid = (abs_pos >= 0) & (abs_pos <= ci.long()[:, None])
    if window is not None:
        valid &= abs_pos > ci.long()[:, None] - window
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, vf)
    return out.reshape(b, h, d).to(q.dtype)
