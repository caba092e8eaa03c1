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


def _acc_dtype(t) -> torch.dtype:
    """f32, or f64 for f64 inputs (where ``gradcheck`` differentiates)."""
    return torch.promote_types(t.dtype, torch.float32)


def expert_gemm_ref(xe, w):
    """Plain version of the expert GEMM kernel: (E,C,d) @ (E,d,f) in f32,
    cast back to xe's dtype."""
    acc = _acc_dtype(xe)
    return torch.einsum("ecd,edf->ecf", xe.to(acc), w.to(acc)).to(xe.dtype)


def ssd_scan_bwd_ref(x, dt, a, bmat, cmat, dy, dstate=None, *, chunk: int):
    """Plain version of the SSD scan's backward, written out from the
    chunked form (no autograd): for each chunk, with cum = cumsum(dt a)
    inside it, xdt_s = dt_s x_s, S the state at the chunk's start and dS
    the gradient reaching the state at its end,

      dS_prev = e^{cum_L} dS + sum_l e^{cum_l} dy_l C_l^T      (reverse scan)
      dC_l   = sum_{s<=l} (dy_l.xdt_s) e^{cum_l-cum_s} B_s + e^{cum_l} S^T dy_l
      dB_s   = sum_{l>=s} (dy_l.xdt_s) e^{cum_l-cum_s} C_l + e^{cum_L-cum_s} dS^T xdt_s
      dxdt_s = sum_{l>=s} (C_l.B_s) e^{cum_l-cum_s} dy_l + e^{cum_L-cum_s} dS B_s

    and each exp term's share of dcum, reverse-summed into ddt and dA.
    exp() sees segment differences only, as the forward.  dy (B,S,H,P),
    dstate (B,H,P,N) or None -> (dx, ddt, da, dB, dC) in the dtypes of
    x, dt, a, bmat, cmat; B and C grouped (summed over a group's heads)."""
    b, s, h, pdim = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc, L, rep = s // chunk, chunk, h // g
    xc = x.reshape(b, nc, L, h, pdim).float()
    dtc = dt.reshape(b, nc, L, h).float()
    Bc = bmat.reshape(b, nc, L, g, n).repeat_interleave(rep, dim=3).float()
    Cc = cmat.reshape(b, nc, L, g, n).repeat_interleave(rep, dim=3).float()
    dyc = dy.reshape(b, nc, L, h, pdim).float()
    af = a.float()
    cum = torch.cumsum((dtc * af).movedim(-1, 2), dim=-1)   # (b,nc,h,L)
    cum_last = cum[..., -1]                                 # (b,nc,h)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    seg = cum[..., :, None] - cum[..., None, :]             # (b,nc,h,l,s)
    E = torch.exp(seg.masked_fill(~mask, -math.inf))
    xdt = xc * dtc[..., None]                               # (b,nc,L,h,p)
    w_in = torch.exp(cum).movedim(2, 3)                     # (b,nc,L,h)
    w_end = torch.exp(cum_last[..., None] - cum).movedim(2, 3)
    # chunk-start states (forward) and end-of-chunk gradients (reverse)
    local = torch.einsum("bcsh,bcshn,bcshp->bchpn", w_end, Bc, xdt)
    dlocal = torch.einsum("bclh,bclhn,bclhp->bchpn", w_in, Cc, dyc)
    decay = torch.exp(cum_last)                             # (b,nc,h)
    S = torch.zeros((b, h, pdim, n), device=x.device)
    dS = (torch.zeros_like(S) if dstate is None
          else dstate.float().clone())
    starts, ends = [], [None] * nc
    for c in range(nc):
        starts.append(S)
        S = decay[:, c, :, None, None] * S + local[:, c]
    for c in reversed(range(nc)):
        ends[c] = dS
        dS = decay[:, c, :, None, None] * dS + dlocal[:, c]
    S0, dSe = torch.stack(starts, 1), torch.stack(ends, 1)  # (b,nc,h,p,n)
    # intra-chunk terms
    CB = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    G = torch.einsum("bclhp,bcshp->bchls", dyc, xdt)
    GE, CBE = G * E, CB * E
    T = GE * CB
    # the state terms, each with its dcum share
    dC_in = w_in[..., None] * torch.einsum("bchpn,bclhp->bclhn", S0, dyc)
    dB_st = w_end[..., None] * torch.einsum("bchpn,bcshp->bcshn", dSe, xdt)
    dxdt_st = w_end[..., None] * torch.einsum("bchpn,bcshn->bcshp", dSe, Bc)
    dC = torch.einsum("bchls,bcshn->bclhn", GE, Bc) + dC_in
    dB = torch.einsum("bchls,bclhn->bcshn", GE, Cc) + dB_st
    dxdt = torch.einsum("bchls,bclhp->bcshp", CBE, dyc) + dxdt_st
    U = (Cc * dC_in).sum(-1).movedim(3, 2)                  # (b,nc,h,L)
    V = (xdt * dxdt_st).sum(-1).movedim(3, 2)
    W = decay * (dSe * S0).sum((-1, -2))                    # (b,nc,h)
    dcum = T.sum(-1) - T.sum(-2) + U - V
    dcum[..., -1] += V.sum(-1) + W
    rc = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    rc = rc.movedim(2, 3)                                   # (b,nc,L,h)
    ddt = (xc * dxdt).sum(-1) + af * rc
    da = (dtc * rc).sum((0, 1, 2))
    dx = dtc[..., None] * dxdt
    dB = dB.reshape(b, nc, L, g, rep, n).sum(4)
    dC = dC.reshape(b, nc, L, g, rep, n).sum(4)
    return (dx.reshape(x.shape).to(x.dtype), ddt.reshape(dt.shape).to(dt.dtype),
            da.to(a.dtype), dB.reshape(bmat.shape).to(bmat.dtype),
            dC.reshape(cmat.shape).to(cmat.dtype))


def expert_gemm_bwd_ref(xe, w, dy):
    """Plain version of the expert GEMM's backward: dX = dY W^T and
    dW = X^T dY per expert (the latter summed over C), in f32, cast
    back to the inputs' dtypes -> (dx (E,C,d), dw (E,d,f))."""
    acc = _acc_dtype(xe)
    dyf = dy.to(acc)
    dx = torch.einsum("ecf,edf->ecd", dyf, w.to(acc))
    dw = torch.einsum("ecd,ecf->edf", xe.to(acc), dyf)
    return dx.to(xe.dtype), dw.to(w.dtype)
