"""Token-level Mixture-of-Experts layer (GShard-style and scatter-based).

The port of ``repro/models/moe_layer.py``.  Two dispatch implementations
(selectable via ``MoEConfig.impl``):

- ``dense``   : GShard capacity dispatch via one-hot einsums, grouped to
                bound memory.
- ``scatter`` : capacity-bucket scatter + batched expert GEMM + gather.

Both run the expert FFN as per-expert batched products (E, C, d) @
(E, d, f).  With ``cfg.attn_impl == "pallas"`` each of those products
goes through ``ops.expert_gemm`` (the CUDA kernel on the card); the
reference computes them with ``einsum`` always.  Shared experts stay a
plain MLP, as in the reference.

This is the *token-level* MoE used inside the MoE architectures,
orthogonal to DiPaCo's document-level path routing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .config import ModelConfig, MoEConfig
from .layers import _normal, apply_mlp, init_mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    s = 1.0 / math.sqrt(d)
    p = {
        "router": _normal(gen, (d, e), s),
        "w_gate": _normal(gen, (e, d, f), s),
        "w_up": _normal(gen, (e, d, f), s),
        "w_down": _normal(gen, (e, f, d), 1.0 / math.sqrt(f)),
    }
    if m.num_shared > 0:
        p["shared"] = init_mlp(gen, cfg,
                               d_ff=m.d_ff_shared or m.num_shared * f)
    return p


def _router_topk(p, m: MoEConfig, x):
    """x: (N, d) -> gates (N, k), idx (N, k), aux_loss scalar.

    The router logits are f32 from x's dtype, as the reference's
    ``preferred_element_type=f32`` gives them: each product of two bf16
    values is exact in f32, and the sum is taken in f32."""
    logits = x.float() @ p["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss
    e = m.num_experts
    frac = F.one_hot(idx, e).float().mean(dim=(0, 1))
    prob_mean = probs.mean(dim=0)
    aux = e * torch.sum(frac * prob_mean) * m.router_aux_weight
    return gates.to(x.dtype), idx, aux


def _expert_matmul(cfg: ModelConfig, xe, w):
    """'...ecd,edf->...ecf'.  Under ``attn_impl == "pallas"`` the leading
    dims fold into the capacity axis, (G,E,C,d) -> (E,G*C,d), for one
    ``ops.expert_gemm`` call."""
    if cfg.attn_impl != "pallas":
        return torch.einsum("...ecd,edf->...ecf", xe, w)
    lead, (e, c, d) = xe.shape[:-3], xe.shape[-3:]
    x3 = xe.reshape(-1, e, c, d).movedim(0, 1).reshape(e, -1, d)
    y3 = ops.expert_gemm(x3, w)                          # (E, G*C, f)
    f = y3.shape[-1]
    return y3.reshape(e, -1, c, f).movedim(1, 0).reshape(*lead, e, c, f)


def _expert_ffn(p, cfg: ModelConfig, xe):
    """xe: (..., E, C, d) batched per-expert FFN."""
    dt = xe.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        gate = _expert_matmul(cfg, xe, p["w_gate"].to(dt))
        act = F.silu(gate) if cfg.mlp_type == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = act * _expert_matmul(cfg, xe, p["w_up"].to(dt))
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(_expert_matmul(cfg, xe, p["w_up"].to(dt))))
    else:
        h = F.gelu(_expert_matmul(cfg, xe, p["w_up"].to(dt)),
                   approximate="tanh")
    return _expert_matmul(cfg, h, p["w_down"].to(dt))


def moe_dense_dispatch(p, cfg: ModelConfig, x, group_size: int = 1024):
    """GShard capacity dispatch.  x: (B, S, d) -> (y, aux)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    dev = x.device
    xf = x.reshape(n, d)
    gates, idx, aux = _router_topk(p, m, xf)
    g = min(group_size, n)
    ng = -(-n // g)
    pad = ng * g - n
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        gates = F.pad(gates, (0, 0, 0, pad))
        idx = F.pad(idx, (0, 0, 0, pad), value=0)
        # padded tokens get zero gate so they contribute nothing
        gates = gates * (torch.arange(ng * g, device=dev)[:, None] < n)
    k = m.top_k
    e = m.num_experts
    cap = max(1, int(g * k * m.capacity_factor / e))
    if g <= 64:
        cap = g  # tiny batches (decode): dropless capacity
    xg = xf.reshape(ng, g, d)
    # flatten (token, choice) -> t for capacity counting within each group
    idx_t = idx.reshape(ng, g * k)
    gates_t = gates.reshape(ng, g * k).float()
    onehot_t = F.one_hot(idx_t, e).float()                     # (G,t,E)
    pos_t = torch.cumsum(onehot_t, dim=1) - onehot_t
    pos_c = torch.sum(pos_t * onehot_t, dim=-1).long()         # (G,t)
    kept = pos_c < cap
    keep = kept.float()
    # an over-capacity position one-hots to zeros, as jax.nn.one_hot does
    pos_oh = F.one_hot(torch.where(kept, pos_c, 0), cap).float() \
        * keep[..., None]
    oh_k = (onehot_t * keep[..., None]).reshape(ng, g, k, e)
    pos_k = pos_oh.reshape(ng, g, k, cap)
    gat_k = gates_t.reshape(ng, g, k)
    # (G,g,E,C) tensors; contract k pairwise to avoid (G,g,k,E,C) transient
    dispatch = torch.einsum("Ggke,Ggkc->Ggec", oh_k, pos_k).to(x.dtype)
    combine = torch.einsum("Ggke,Ggkc->Ggec", oh_k * gat_k[..., None], pos_k)
    xe = torch.einsum("Ggec,Ggd->Gecd", dispatch, xg)          # (G,E,C,d)
    ye = _expert_ffn(p, cfg, xe)                               # (G,E,C,d)
    y = torch.einsum("Ggec,Gecd->Ggd", combine.to(x.dtype), ye)
    y = y.reshape(ng * g, d)[:n].reshape(b, s, d)
    if m.num_shared > 0:
        y = y + apply_mlp(p["shared"], cfg, x)
    return y, aux


def moe_scatter_dispatch(p, cfg: ModelConfig, x):
    """Capacity-bucket scatter dispatch: memory-traffic dispatch, GEMM-only
    expert compute.  x: (B, S, d) -> (y, aux)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    dev = x.device
    xf = x.reshape(n, d)
    gates, idx, aux = _router_topk(p, m, xf)
    e = m.num_experts
    cap = max(1, int(n * m.top_k * m.capacity_factor / e))
    flat_e = idx.reshape(-1)                                   # (n*k,)
    token_of = torch.arange(n, device=dev).repeat_interleave(m.top_k)
    gate_of = gates.reshape(-1)
    # position of each (token, choice) within its expert bucket
    onehot = F.one_hot(flat_e, e)                              # (n*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, e * cap))      # overflow -> dump row
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xf[token_of]
    xe = buf[:-1].reshape(1, e, cap, d)
    ye = _expert_ffn(p, cfg, xe).reshape(e * cap, d)
    ye = torch.cat([ye, torch.zeros((1, d), dtype=ye.dtype, device=dev)])
    contrib = ye[slot] * (gate_of * keep).to(ye.dtype)[:, None]
    y = torch.zeros((n, d), dtype=x.dtype, device=dev).index_add_(
        0, token_of, contrib.to(x.dtype))
    y = y.reshape(b, s, d)
    if m.num_shared > 0:
        y = y + apply_mlp(p["shared"], cfg, x)
    return y, aux


def apply_moe(p, cfg: ModelConfig, x):
    if cfg.moe.impl == "scatter":
        return moe_scatter_dispatch(p, cfg, x)
    return moe_dense_dispatch(p, cfg, x)
