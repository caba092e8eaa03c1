"""Mamba2 mixer: SSD (state-space duality) chunked scan.

The port of ``repro/models/ssm.py``.  The block follows the canonical
Mamba2 layout:

  in_proj -> [z, x, B, C, dt]; causal conv over (x,B,C); SSD; gated
  RMSNorm; out_proj.

The full-sequence SSD goes through ``ops.ssd_scan`` (the CUDA kernel on
the card) when ``cfg.attn_impl == "pallas"``, else through the plain
``ref.ssd_scan_ref`` (the port of the reference's ``ssd_chunked``, which
the reference runs always).
Decode keeps (conv_state, ssm_state) and runs the O(1) recurrence.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

from .config import ModelConfig
from .layers import _normal, rms_norm


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def init_mamba(gen: torch.Generator, cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    dev = gen.device
    d_inner, n_heads, conv_dim = ssm_dims(cfg)
    proj_out = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    # dt bias initialised so softplus(dt_bias) spans [dt_min, dt_max]
    u = torch.rand((n_heads,), generator=gen, device=dev)
    dt_init = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                        + math.log(s.dt_min))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inv softplus
    return {
        "in_proj": _normal(gen, (d, proj_out), 1.0 / math.sqrt(d)),
        "conv_w": _normal(gen, (s.conv_width, conv_dim), 0.1),
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((n_heads,), device=dev),
        "norm": torch.ones((d_inner,), device=dev),
        "out_proj": _normal(gen, (d_inner, d), 1.0 / math.sqrt(d_inner)),
    }


def _causal_conv(x, w, b):
    """x: (B,S,C), w: (W,C) depthwise causal conv."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    return out + b


def _pad_seq(t, pad: int):
    """Zero-pad dim 1 (the sequence) of a (B, S, ...) tensor at the end."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def apply_mamba(p, cfg: ModelConfig, u, *, state=None, return_state=False):
    """u: (B,S,d_model) -> (y, new_state or None).

    state: dict(conv=(B,W-1,conv_dim), ssm=(B,h,p,n)) for decode.
    return_state: on the full-sequence (prefill) path, also return the
    state after the last token so decode can continue incrementally.
    The caller writes ``new_state`` into its cache.
    """
    s_cfg = cfg.ssm
    b, s, _ = u.shape
    d_inner, n_heads, conv_dim = ssm_dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., -n_heads:]
    conv_w, conv_b = p["conv_w"].to(u.dtype), p["conv_b"].to(u.dtype)
    new_state = None
    if state is not None:
        # decode: s == 1; roll conv state
        conv_in = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
        xbc_conv = F.silu(torch.einsum("bwc,wc->bc", conv_in, conv_w)
                          + conv_b)[:, None, :]
        new_conv = conv_in[:, 1:]
    else:
        xbc_conv = F.silu(_causal_conv(xbc, conv_w, conv_b))
    x = xbc_conv[..., :d_inner].reshape(b, s, n_heads, s_cfg.head_dim)
    B = xbc_conv[..., d_inner:d_inner + gn].reshape(
        b, s, s_cfg.n_groups, s_cfg.d_state)
    C = xbc_conv[..., d_inner + gn:].reshape(
        b, s, s_cfg.n_groups, s_cfg.d_state)
    dt = F.softplus(dt_raw.float()
                    + p["dt_bias"].float()[None, None, :])   # (b,s,h)
    A = -torch.exp(p["A_log"])                              # (h,) negative
    if state is not None:
        # O(1) recurrence for a single token
        dA = torch.exp(dt[:, 0] * A.float()[None, :])       # (b,h)
        rep = n_heads // s_cfg.n_groups
        Bh = B[:, 0].repeat_interleave(rep, dim=1).float()  # (b,h,n)
        Ch = C[:, 0].repeat_interleave(rep, dim=1).float()
        xdt = x[:, 0].float() * dt[:, 0][..., None]          # (b,h,p)
        ssm = state["ssm"] * dA[..., None, None] \
            + xdt[..., None] * Bh[:, :, None, :]             # (b,h,p,n)
        y = torch.einsum("bhpn,bhn->bhp", ssm, Ch)
        yf = y[:, None].to(u.dtype)                          # (b,1,h,p)
        new_state = {"conv": new_conv, "ssm": ssm}
    else:
        chunk = min(s_cfg.chunk, s)
        pad = (-s) % chunk
        x_, dt_, B_, C_ = ((_pad_seq(t, pad) for t in (x, dt, B, C))
                           if pad else (x, dt, B, C))
        if cfg.attn_impl == "pallas":
            yf, final = ops.ssd_scan(x_, dt_, A, B_, C_, chunk=chunk)
        else:
            yf, final = ref.ssd_scan_ref(x_, dt_, A, B_, C_, chunk=chunk)
        yf = yf[:, :s]
        if return_state:
            # chunk padding is state-exact: padded dt is 0, so padded
            # steps neither decay nor inject input into `final`
            W = s_cfg.conv_width
            conv_tail = xbc[:, max(0, s - (W - 1)):s]
            if s < W - 1:
                conv_tail = F.pad(conv_tail, (0, 0, W - 1 - s, 0))
            new_state = {"conv": conv_tail, "ssm": final}
    yf = yf + x * p["D"].to(yf.dtype)[None, None, :, None]
    yf = yf.reshape(b, s, d_inner)
    # gated RMSNorm (mamba2 style)
    yf = rms_norm(p["norm"], yf * F.silu(z), cfg.norm_eps)
    return yf @ p["out_proj"].to(u.dtype), new_state


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                   device):
    s = cfg.ssm
    d_inner, n_heads, conv_dim = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, n_heads, s.head_dim, s.d_state),
                           device=device),
    }
