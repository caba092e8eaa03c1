"""Per-expert batched GEMM: wrapper of the CUDA kernel ``csrc/moe_gmm.cu``
(replaces the TPU kernel ``repro/kernels/moe_gmm.py:38 expert_gemm``).

Takes CUDA tensors only; ``ops.expert_gemm`` sends CPU tensors to the
plain version (``ref.expert_gemm_ref``).  ``expert_gemm.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attention import DTYPES


def _lib():
    fn = build.load("moe_gmm").expert_gemm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def expert_gemm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d), w (E, d, f), f32 or bf16 of one dtype -> (E, C, f) in
    their dtype, accumulated in f32."""
    if not (xe.is_cuda and w.device == xe.device):
        raise ValueError("expert_gemm kernel takes CUDA tensors on one "
                         f"device, got {xe.device}, {w.device}")
    if xe.dtype not in DTYPES or w.dtype != xe.dtype:
        raise TypeError(f"expert_gemm takes f32 or bf16 xe and w of one "
                        f"dtype, got {xe.dtype}, {w.dtype}")
    if xe.ndim != 3 or w.ndim != 3 or w.shape[:2] != (xe.shape[0],
                                                      xe.shape[2]):
        raise ValueError(f"bad shapes xe {tuple(xe.shape)}, w "
                         f"{tuple(w.shape)}")
    e, c, d = xe.shape
    f = w.shape[2]
    if min(e, c, d, f) < 1:
        raise ValueError(f"empty input: xe {tuple(xe.shape)}, w "
                         f"{tuple(w.shape)}")
    if e > 65535:
        raise ValueError(f"E = {e} exceeds the grid's 65535")
    if not (xe.is_contiguous() and w.is_contiguous()):
        raise ValueError("expert_gemm takes contiguous xe and w")
    out = torch.empty((e, c, f), dtype=xe.dtype, device=xe.device)
    rc = _lib()(xe.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                DTYPES[xe.dtype],
                torch.cuda.current_stream(xe.device).cuda_stream)
    build.check_rc(rc, "expert_gemm")
    expert_gemm.launches += 1
    return out


expert_gemm.launches = 0
