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


def _attention_mask(s: int, causal: bool, window, device) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _masked_scores(q, k, causal, window):
    """(B,S,H,D), (B,S,KH,D) -> masked scaled scores (B,KH,G,S,S) f32."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(d)
    mask = _attention_mask(s, causal, window, q.device)
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def fwd_with_lse_ref(q, k, v, *, causal=True, window=None):
    """Plain version of the training forward (the reference's
    ``_fwd_with_lse``): (o (B,S,H,D) in q's dtype, lse (B,H,S) f32) with
    lse = m + log(max(l, 1e-30))."""
    b, s, h, d = q.shape
    scores = _masked_scores(q, k, causal, window)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    l = torch.clamp_min(e.sum(dim=-1), 1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", e / l[..., None], v.float())
    lse = (m + torch.log(l)).reshape(b, h, s)
    return o.reshape(b, s, h, d).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True,
                            window=None):
    """Plain version of the two backward kernels (the reference's
    ``flash_attention_bwd``): p recomputed as exp(s - lse), then dV, dK
    summed over each KV head's query heads, and dQ; in q's dtype."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    p = torch.exp(_masked_scores(q, k, causal, window)
                  - lse.reshape(b, kh, g, s)[..., None])     # (B,KH,G,S,S)
    dog = do.reshape(b, s, kh, g, d).float()
    qg = q.reshape(b, s, kh, g, d).float()
    delta = (dog * o.reshape(b, s, kh, g, d).float()).sum(-1)  # (B,S,KH,G)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(b, s, h, d)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def router_assign_ref(z, centroids):
    """Plain version of the k-means assignment kernel (Eq. 1): argmin of
    the expanded ||z||^2 - 2 z.c + ||c||^2 in f32, ties to the first
    index -> (assign (N,) int32, min d2 (N,) f32)."""
    zf = z.float()
    cf = centroids.float()
    d2 = ((zf * zf).sum(-1, keepdim=True) - 2 * zf @ cf.T
          + (cf * cf).sum(-1)[None, :])
    mind2, assign = d2.min(dim=-1)
    return assign.to(torch.int32), mind2


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
