"""Per-expert batched GEMM: wrappers of the CUDA kernels in
``csrc/moe_gmm.cu``, and the autograd Function that joins them.

  expert_gemm     the forward (replaces the TPU kernel
                  ``repro/kernels/moe_gmm.py:38 expert_gemm``)
  expert_gemm_dx  the backward's dX = dY W^T
  expert_gemm_dw  the backward's dW = X^T dY (the TPU package has no
                  backward kernel: its models differentiate the einsum)

They take CUDA tensors only and count their launches (``.launches``).
``ExpertGemm`` reaches them through ``ops``, which sends CPU tensors to
the plain versions (``ref.expert_gemm_ref``, ``ref.expert_gemm_bwd_ref``),
so the Function is the same on both devices.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attention import DTYPES


def _lib(name: str = "expert_gemm"):
    fn = getattr(build.load("moe_gmm"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, xe: torch.Tensor, w: torch.Tensor,
           dy: torch.Tensor = None) -> tuple:
    """Raise unless xe (E, C, d), w (E, d, f) and, for the backward, dy
    (E, C, f) are contiguous CUDA tensors of one dtype the kernels take;
    -> (e, c, d, f)."""
    ts = (xe, w) if dy is None else (xe, w, dy)
    if not (xe.is_cuda and all(t.device == xe.device for t in ts)):
        raise ValueError(f"{name} kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    if xe.dtype not in DTYPES or any(t.dtype != xe.dtype for t in ts):
        raise TypeError(f"{name} takes f32 or bf16 inputs of one dtype, "
                        f"got {[t.dtype for t in ts]}")
    if xe.ndim != 3 or w.ndim != 3 or w.shape[:2] != (xe.shape[0],
                                                      xe.shape[2]):
        raise ValueError(f"bad shapes xe {tuple(xe.shape)}, w "
                         f"{tuple(w.shape)}")
    e, c, d = xe.shape
    f = w.shape[2]
    if dy is not None and dy.shape != (e, c, f):
        raise ValueError(f"bad shape dy {tuple(dy.shape)}, want {(e, c, f)}")
    if min(e, c, d, f) < 1:
        raise ValueError(f"empty input: xe {tuple(xe.shape)}, w "
                         f"{tuple(w.shape)}")
    if e > 65535:
        raise ValueError(f"E = {e} exceeds the grid's 65535")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous inputs")
    return e, c, d, f


def expert_gemm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d), w (E, d, f), f32 or bf16 of one dtype -> (E, C, f) in
    their dtype, accumulated in f32."""
    e, c, d, f = _check("expert_gemm", xe, w)
    out = torch.empty((e, c, f), dtype=xe.dtype, device=xe.device)
    rc = _lib()(xe.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                DTYPES[xe.dtype],
                torch.cuda.current_stream(xe.device).cuda_stream)
    build.check_rc(rc, "expert_gemm")
    build.count_launch(expert_gemm)
    return out


def expert_gemm_dx(dy: torch.Tensor, w: torch.Tensor,
                   xe: torch.Tensor) -> torch.Tensor:
    """dy (E, C, f), w (E, d, f) -> dX = dY W^T (E, C, d) in their dtype
    (xe gives the shape and is not read)."""
    e, c, d, f = _check("expert_gemm_dx", xe, w, dy)
    dx = torch.empty((e, c, d), dtype=dy.dtype, device=dy.device)
    rc = _lib("expert_gemm_dx")(
        dy.data_ptr(), w.data_ptr(), dx.data_ptr(), e, c, d, f,
        DTYPES[dy.dtype], torch.cuda.current_stream(dy.device).cuda_stream)
    build.check_rc(rc, "expert_gemm_dx")
    build.count_launch(expert_gemm_dx)
    return dx


def expert_gemm_dw(xe: torch.Tensor, dy: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d), dy (E, C, f) -> dW = X^T dY (E, d, f) in their dtype,
    summed over C in one fixed order (w gives the shape and is not
    read)."""
    e, c, d, f = _check("expert_gemm_dw", xe, w, dy)
    dw = torch.empty((e, d, f), dtype=xe.dtype, device=xe.device)
    rc = _lib("expert_gemm_dw")(
        xe.data_ptr(), dy.data_ptr(), dw.data_ptr(), e, c, d, f,
        DTYPES[xe.dtype], torch.cuda.current_stream(xe.device).cuda_stream)
    build.check_rc(rc, "expert_gemm_dw")
    build.count_launch(expert_gemm_dw)
    return dw


expert_gemm.launches = 0
expert_gemm_dx.launches = 0
expert_gemm_dw.launches = 0


class ExpertGemm(torch.autograd.Function):
    """Differentiable expert GEMM: the forward kernel, and dX and dW
    kernels as its backward (each only where its input needs it)."""

    @staticmethod
    def forward(ctx, xe, w):
        from . import ops
        xe, w = xe.contiguous(), w.contiguous()
        ctx.save_for_backward(xe, w)
        return ops.expert_gemm_fwd(xe, w)

    @staticmethod
    def backward(ctx, dy):
        from . import ops
        xe, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad
        return ops.expert_gemm_bwd(xe, w, dy.contiguous().to(xe.dtype),
                                   need_dx=need_dx, need_dw=need_dw)
