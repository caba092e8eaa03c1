"""Flash attention for training: the forward that writes the log-sum-exp
rows, the two backward kernels, and the autograd Function that joins
them (the port of ``repro/kernels/flash_attention_bwd.py``).

Wrappers of the CUDA kernels, each counting its launches:

  flash_attention_lse   csrc/flash_attention.cu (LSE = true); replaces
                        ``_fwd_with_lse_aligned`` (:116, ``_fwd_lse_kernel``)
  flash_attention_dkv   csrc/flash_attention_bwd.cu; replaces the first
                        pallas_call of ``flash_attention_bwd`` (:293,
                        ``_dkv_kernel``)
  flash_attention_dq    csrc/flash_attention_bwd.cu; replaces the second
                        (:331, ``_dq_kernel``)

They take CUDA tensors only.  ``FlashAttention`` reaches them through
``ops``, which sends CPU tensors to the plain versions in ``ref.py``, so
the Function is the same on both devices.  All three take every head
dim of ``flash_attention.HEAD_DIMS`` (32, 64, 128, 192, 256); at 192 and
256 the bf16 dK/dV runs as two launches over the columns of dK and dV
(csrc/flash_attention_bwd.cu), and counts two (``dkv_launches``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .flash_attention import DTYPES, check_qkv

def _fn(lib: str, name: str, n_ptr: int, n_int: int):
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> tuple:
    """q (B,S,H,D); k, v (B,S,KH,D) -> (o (B,S,H,D) in q's dtype,
    lse (B,H,S) f32)."""
    b, s, h, kh, d = check_qkv("flash_attention_lse", q, k, v, window)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rc = _fn("flash_attention", "flash_attention_fwd_lse", 5, 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, kh, d, int(causal), window or 0,
        DTYPES[q.dtype], _stream(q))
    build.check_rc(rc, "flash_attention_lse")
    build.count_launch(flash_attention_lse)
    return out, lse


def _check_bwd(name, q, k, v, do, lse, delta, window) -> tuple:
    dims = check_qkv(name, q, k, v, window)
    b, s, h = dims[:3]
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError(f"{name}: do must be contiguous like q, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if tuple(t.shape) != (b, h, s) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous f32 "
                             f"({b}, {h}, {s}) on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return dims


def dkv_launches(dtype: torch.dtype, d: int) -> int:
    """The kernel launches of one dK/dV call: the bf16 kernel takes dK's
    and dV's columns 128 at a time (``dkv_cols`` in the .cu), the f32
    kernel all of them at once."""
    return -(-d // 128) if dtype == torch.bfloat16 else 1


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: Optional[int] = None) -> tuple:
    """-> (dk, dv), each (B,S,KH,D) in q's dtype, summed over the query
    heads of each KV head.  delta = rowsum(do * o) as (B,H,S) f32."""
    b, s, h, kh, d = _check_bwd("flash_attention_dkv", q, k, v, do, lse,
                                delta, window)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _fn("flash_attention_bwd", "flash_attention_bwd_dkv", 8, 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, h, kh, d, int(causal), window or 0, DTYPES[q.dtype],
        _stream(q))
    build.check_rc(rc, "flash_attention_dkv")
    for _ in range(dkv_launches(q.dtype, d)):
        build.count_launch(flash_attention_dkv)
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                       window: Optional[int] = None) -> torch.Tensor:
    """-> dq (B,S,H,D) in q's dtype."""
    b, s, h, kh, d = _check_bwd("flash_attention_dq", q, k, v, do, lse,
                                delta, window)
    dq = torch.empty_like(q)
    rc = _fn("flash_attention_bwd", "flash_attention_bwd_dq", 7, 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, kh, d,
        int(causal), window or 0, DTYPES[q.dtype], _stream(q))
    build.check_rc(rc, "flash_attention_dq")
    build.count_launch(flash_attention_dq)
    return dq


flash_attention_lse.launches = 0
flash_attention_dkv.launches = 0
flash_attention_dq.launches = 0


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in f32, (B,S,H,D) -> (B,H,S) contiguous, as
    the reference computes it outside its kernels (:289-291)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the reference's
    ``flash_attention_trainable`` custom_vjp: the forward saves
    (q, k, v, o, lse), the backward recomputes p from lse tile by tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        from . import ops
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = ops.fwd_with_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        from . import ops
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(
            q, k, v, o, lse, do.contiguous().to(q.dtype), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None
