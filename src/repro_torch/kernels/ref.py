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


def _segsum(x):
    """x: (..., T) -> (..., T, T) cumulative segment sums, -inf above diag."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def ssd_scan_ref(x, dt, a, bmat, cmat, *, chunk: int):
    """Plain version of the SSD scan kernel, and the Mamba2 mixer's plain
    path: the port of the reference's chunked SSD (``ssd_chunked``), a
    linear-time inter-chunk scan plus the quadratic intra-chunk part.
    x (B,S,H,P), dt (B,S,H), a (H,) negative, bmat/cmat (B,S,G,N)
    grouped -> (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    b, s, h, pdim = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rep = h // g
    xc = x.reshape(b, nc, chunk, h, pdim).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = bmat.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()
    Cc = cmat.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()
    dA = (dtc * a.float()).movedim(-1, 2)               # (b,nc,h,l) log-decay
    dA_cum = torch.cumsum(dA, dim=-1)                   # (b,nc,h,l)
    # intra-chunk (quadratic within chunk)
    L = torch.exp(_segsum(dA))                          # (b,nc,h,l,l)
    xdt = xc * dtc[..., None]                           # dt-weighted inputs
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * L, xdt)
    # per-chunk end states
    decay_end = torch.exp(dA_cum[..., -1:] - dA_cum)    # (b,nc,h,l)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          Bc * decay_end.movedim(2, 3)[..., None], xdt)
    # inter-chunk linear scan
    chunk_decay = torch.exp(dA_cum[..., -1])            # (b,nc,h)
    state = torch.zeros((b, h, pdim, n), device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(state)                            # state at chunk start
        state = chunk_decay[:, c, :, None, None] * state + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                 # (b,nc,h,p,n)
    decay_in = torch.exp(dA_cum).movedim(2, 3)          # (b,nc,l,h)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, h_prev) \
        * decay_in[..., None]
    y = (y_diag + y_off).reshape(b, s, h, pdim)
    return y.to(x.dtype), state


def expert_gemm_ref(xe, w):
    """Plain version of the expert GEMM kernel: (E,C,d) @ (E,d,f) in f32,
    cast back to xe's dtype."""
    return torch.einsum("ecd,edf->ecf", xe.float(), w.float()).to(xe.dtype)
