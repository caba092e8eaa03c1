"""Core neural-net layers in PyTorch: norms, RoPE, attention, MLPs.

The port of ``repro/models/layers.py``, cross-attention included.
``init_*`` take a ``torch.Generator`` and allocate on its device; they
mirror the reference's shapes and scales, not its random streams.
``apply`` functions are plain functions on tensors, except that a
decode cache is updated in place (where the reference donates it).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ring_positions

from .config import ModelConfig

NEG_INF = -1e30


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rmsnorm(gen: torch.Generator, dim: int):
    return torch.ones((dim,), device=gen.device)


def rms_norm(scale, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim//2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S).
    Rotates the two halves of D (not interleaved pairs)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs    # (..., S, d//2)
    cos = torch.cos(angles)[..., :, None, :]            # (..., S, 1, d//2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig):
    """Self- or cross-attention weights: both have the same keys and
    shapes."""
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s_in = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, h, hd), s_in),
        "wk": _normal(gen, (d, kh, hd), s_in),
        "wv": _normal(gen, (d, kh, hd), s_in),
        "wo": _normal(gen, (h, hd, d), 1.0 / math.sqrt(h * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=gen.device)
        p["k_norm"] = torch.ones((hd,), device=gen.device)
    return p


def _gqa_scores(q, k):
    """q: (B,Sq,KH,G,D), k: (B,Sk,KH,D) -> (B,KH,G,Sq,Sk) in f32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def _gqa_out(p, v):
    """p: (B,KH,G,Sq,Sk), v: (B,Sk,KH,D) -> (B,Sq,KH,G,D)."""
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))


def _masked(scores, mask):
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def full_attention(q, k, v, *, causal: bool, window: Optional[int]):
    """Plain O(S^2)-memory attention.  q: (B,Sq,H,D), k/v: (B,Sk,KH,D)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d)
    scores = _gqa_scores(qg, k) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    p = torch.softmax(_masked(scores, mask), dim=-1)
    out = _gqa_out(p, v)
    return out.reshape(b, sq, h, d).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      chunk_q: int = 512, chunk_k: int = 512,
                      causal_skip: bool = False):
    """Online-softmax blockwise attention; O(S*chunk) activation memory.

    With ``causal_skip`` the fully-masked (future) key chunks are
    skipped, and with a window also the fully-expired past chunks.
    """
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    dev = q.device
    nq = -(-s // chunk_q)
    pad_q = nq * chunk_q - s
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    nk = -(-k.shape[1] // chunk_k)
    pad_k = nk * chunk_k - k.shape[1]
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    sk_pad = nk * chunk_k
    qc = q.reshape(b, nq, chunk_q, kh, g, d).float()
    kc = k.reshape(b, nk, chunk_k, kh, d).float()
    vc = v.reshape(b, nk, chunk_k, kh, d).float()
    scale = 1.0 / math.sqrt(d)
    kpos_all = torch.arange(sk_pad, device=dev).reshape(nk, chunk_k)
    valid_k = kpos_all < (sk_pad - pad_k)

    blocks = []
    for i in range(nq):
        qi = qc[:, i]
        m = torch.full((b, kh, g, chunk_q), NEG_INF, device=dev)
        l = torch.zeros((b, kh, g, chunk_q), device=dev)
        acc = torch.zeros((b, kh, g, chunk_q, d), device=dev)
        js = range(nk)
        if causal_skip:
            lo = 0
            if window is not None:
                lo = max(0, (i * chunk_q - window) // chunk_k)
            hi = min(nk, ((i + 1) * chunk_q - 1) // chunk_k + 1) \
                if causal else nk
            js = range(lo, max(hi, lo + 1))
        qpos = i * chunk_q + torch.arange(chunk_q, device=dev)
        for j in js:
            scores = torch.einsum("bqkgd,bskd->bkgqs", qi, kc[:, j]) * scale
            kpos = kpos_all[j]
            mask = valid_k[j][None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            scores = _masked(scores, mask)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vc[:, j])
            m = m_new
        blocks.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(blocks, dim=3)          # (b, kh, g, nq, cq, d)
    out = out.reshape(b, kh, g, nq * chunk_q, d)
    out = out.movedim(3, 1).reshape(b, nq * chunk_q, kh * g, d)
    return out[:, :s].to(q.dtype)


def _cache_positions(cache_index, b: int, device) -> torch.Tensor:
    """Scalar or (B,) write positions -> (B,) int32 on ``device``."""
    ci = torch.as_tensor(cache_index, dtype=torch.int32)
    if ci.device != device:
        ci = ci.to(device, non_blocking=True)
    return ci.reshape(-1).expand(b).contiguous()


def _host_positions(cache_index):
    """The start positions as a numpy array when they live on the host
    (Python or numpy values, or a CPU tensor); None for a device tensor,
    which is never read back for a check."""
    if isinstance(cache_index, torch.Tensor):
        return cache_index.numpy() if cache_index.device.type == "cpu" \
            else None
    return np.asarray(cache_index)


def _row_update_(buf, val, start, mask=None):
    """In-place per-row ring write: buf (B,T,...)[b, start[b]:+s] = val[b]
    for val (B,s,...).  The start is clamped so that the block fits, as
    ``lax.dynamic_update_slice`` does.  Where ``mask`` (B,) bool is False
    the row's old values are written back, so the row stays bit for bit
    as it was (the reference's masked ``sel``); the select runs on the
    device, so the write needs no host sync."""
    b, s = val.shape[:2]
    start = torch.clamp(start, max=buf.shape[1] - s)
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = start[:, None] + torch.arange(s, device=buf.device)[None, :]
    val = val.to(buf.dtype)
    if mask is not None:
        keep = mask.reshape((b,) + (1,) * (val.ndim - 1))
        val = torch.where(keep, val, buf[rows, cols])
    buf[rows, cols] = val


def _quant(x):
    """int8 with per-(token, head) absmax scales; rounds half to even."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                            1e-8)
    qx = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return qx, scale[..., 0]


def _proj(x, w):
    """x (B,S,d) @ w (d,H,K) -> (B,S,H,K).  Path-stacked weights (P,d,H,K)
    with x (P,S,d) give one batched product over P."""
    d, h, k = w.shape[-3:]
    w = w.to(x.dtype).reshape(*w.shape[:-3], d, h * k)
    return (x @ w).reshape(*x.shape[:2], h, k)


def attention_q(p, cfg: ModelConfig, x):
    """The query projection and its qk-norm, no RoPE: x (B,S,d) ->
    (B,S,H,D)."""
    q = _proj(x, p["wq"])
    return rms_norm(p["q_norm"], q, cfg.norm_eps) if cfg.qk_norm else q


def attention_kv(p, cfg: ModelConfig, x):
    """The key and value projections and the key's qk-norm, no RoPE:
    x (B,S,d) -> k, v (B,S,KH,D)."""
    k = _proj(x, p["wk"])
    if cfg.qk_norm:
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return k, _proj(x, p["wv"])


def attention_qkv(p, cfg: ModelConfig, x, positions):
    """Projections, qk-norm and RoPE: x (B,S,d) -> q (B,S,H,D), k and v
    (B,S,KH,D).  With path-stacked weights, x (P,S,d) and positions
    (P,S) (the norms' scales then broadcast as (P,1,1,D))."""
    q = attention_q(p, cfg, x)
    k, v = attention_kv(p, cfg, x)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention_out(p, out):
    """The output projection: out (B,S,H,D) @ wo (H,D,d) -> (B,S,d), or
    one batched product over P for path-stacked wo (P,H,D,d)."""
    h, hd, d = p["wo"].shape[-3:]
    wo = p["wo"].to(out.dtype).reshape(*p["wo"].shape[:-3], h * hd, d)
    return out.reshape(*out.shape[:2], h * hd) @ wo


def apply_attention(p, cfg: ModelConfig, x, *, positions, causal=True,
                    window=None, cache=None, cache_index=None, mask=None,
                    kv_x=None):
    """Multi-head attention with GQA/MQA, optional qk-norm & RoPE.

    cache: optional dict(k=(B,T,KH,D), v=...) for decode/incremental
    prefill, written in place (see ``cached_attention``; ``mask`` (B,)
    leaves the False rows' cache untouched).  kv_x (B,Sk,d) makes it
    cross-attention: K and V come from kv_x, with no RoPE, no causal mask
    and no cache write, through the plain ``full_attention`` (as the
    reference's).  Returns (out, cache), cache None for cross-attention.
    """
    if kv_x is not None:
        k, v = attention_kv(p, cfg, kv_x)
        out = full_attention(attention_q(p, cfg, x), k, v, causal=False,
                             window=window)
        return attention_out(p, out), None
    q, k, v = attention_qkv(p, cfg, x, positions)
    if cache is not None:
        out = cached_attention(cfg, q, k, v, cache, cache_index,
                               window=window, mask=mask)
    elif cfg.attn_impl == "pallas" and causal:
        # the kernel masks the ragged tail itself: no padding to 128.
        # Differentiable: with grads on, ops takes the autograd
        # Function (LSE forward + dK/dV and dQ kernels)
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    elif cfg.attn_impl == "full" or x.shape[1] <= cfg.attn_chunk_q:
        out = full_attention(q, k, v, causal=causal, window=window)
    else:
        out = chunked_attention(
            q, k, v, causal=causal, window=window,
            chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
            causal_skip=cfg.causal_skip)
    return attention_out(p, out), cache


def cached_attention(cfg: ModelConfig, q, k, v, cache, cache_index, *,
                     window=None, mask=None):
    """Write k, v into the ring cache in place, then attend over it.

    q (B,s,H,D), k and v (B,s,KH,D); cache dict(k=(B,T,KH,D), v=..., and
    for int8 k_scale, v_scale (B,T,KH)).  cache_index is the write
    position of the *first* token of this call — a scalar, or a (B,)
    vector when rows sit at different positions.  Multi-token calls
    (s > 1) write the block contiguously and mask causally within it; a
    block that would wrap the ring raises while its start positions are
    host values.  ``mask`` (B,) bool: a False row's cache stays bit for
    bit as it was (its output is computed and meaningless).  Returns the
    attention output (B,s,H,D).
    """
    b, s = q.shape[:2]
    T = cache["k"].shape[1]
    if s > 1:
        if s > T:
            raise ValueError(
                f"multi-token cache write of {s} tokens exceeds "
                f"cache length {T}")
        host = _host_positions(cache_index)
        if host is not None:
            starts = host % T
            if int(starts.max()) + s > T:
                raise ValueError(
                    f"multi-token cache write wraps the ring: start "
                    f"{int(starts.max())} + {s} tokens > cache "
                    f"length {T}; split the block or grow the cache")
    ci = _cache_positions(cache_index, b, q.device)       # (B,)
    idx = ci.long() % T
    quantized = "k_scale" in cache
    if quantized:
        kq, ks = _quant(k)
        vq, vs = _quant(v)
        _row_update_(cache["k"], kq, idx, mask)
        _row_update_(cache["v"], vq, idx, mask)
        _row_update_(cache["k_scale"], ks, idx, mask)
        _row_update_(cache["v_scale"], vs, idx, mask)
    else:
        _row_update_(cache["k"], k, idx, mask)
        _row_update_(cache["v"], v, idx, mask)
    ck, cv = cache["k"], cache["v"]
    if s == 1 and cfg.attn_impl == "pallas":
        # flash-decode streams the ring cache once with an online
        # softmax, masks ring validity from the per-row positions on
        # the device and dequantizes int8 KV in registers
        out = ops.decode_attention(
            q[:, 0].contiguous(), ck, cv, ci, window=window,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
        out = out[:, None].to(q.dtype)                   # (B, 1, H, D)
    else:
        # dense masked branch: prefill (s > 1), and decode unless
        # attn_impl == "pallas"
        if quantized:
            ckf = (ck.float() * cache["k_scale"][..., None]).to(q.dtype)
            cvf = (cv.float() * cache["v_scale"][..., None]).to(q.dtype)
        else:
            ckf, cvf = ck, cv
        kh = ck.shape[2]
        g = cfg.num_heads // kh
        qg = q.reshape(b, s, kh, g, cfg.head_dim)
        scores = (_gqa_scores(qg, ckf.to(q.dtype))
                  / math.sqrt(cfg.head_dim))
        # absolute position stored in each ring slot, per batch row;
        # reconstructed from the position of the *last* token written
        abs_pos = ring_positions(ci.long() + s - 1, T)     # (B, T)
        qpos = ci.long()[:, None] + torch.arange(
            s, device=q.device)[None, :]                  # (B, S)
        valid = ((abs_pos[:, None, :] >= 0)
                 & (abs_pos[:, None, :] <= qpos[..., None]))  # (B,S,T)
        if window is not None:
            valid &= abs_pos[:, None, :] > qpos[..., None] - window
        prob = torch.softmax(_masked(scores, valid[:, None, None]),
                             dim=-1)
        out = _gqa_out(prob, cvf.to(prob.dtype))
        out = out.reshape(b, s, cfg.num_heads,
                          cfg.head_dim).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = 1.0 / math.sqrt(d)
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": _normal(gen, (d, f), s),
                "w_up": _normal(gen, (d, f), s),
                "w_down": _normal(gen, (f, d), 1.0 / math.sqrt(f))}
    # relu2 | gelu: plain 2-matrix MLP
    return {"w_up": _normal(gen, (d, f), s),
            "w_down": _normal(gen, (f, d), 1.0 / math.sqrt(f))}


def apply_mlp(p, cfg: ModelConfig, x):
    t = cfg.mlp_type
    up = x @ p["w_up"].to(x.dtype)
    if t == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * up
    elif t == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_gate"].to(x.dtype), approximate="tanh") * up
    elif t == "relu2":
        h = torch.square(F.relu(up))
    elif t == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_type {t}")
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    p = {"embedding": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab_size),
                               1.0 / math.sqrt(cfg.d_model))
    return p


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def embed_tokens(p, cfg: ModelConfig, tokens):
    x = p["embedding"][tokens.long()].to(torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(p, cfg: ModelConfig, x):
    # logits stay in the activation dtype; the loss upcasts to f32.
    # Path-stacked tables (P,V,d) with x (P,S,d) give one batched product
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].to(x.dtype).transpose(-2, -1)
    else:
        logits = x @ p["unembed"].to(x.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
