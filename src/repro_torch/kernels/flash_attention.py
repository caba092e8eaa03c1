"""Flash-attention forward: wrapper of the CUDA kernel
``csrc/flash_attention.cu`` (replaces the TPU kernel
``repro/kernels/flash_attention.py:81 flash_attention``).

Takes CUDA tensors only; ``ops.flash_attention`` sends CPU tensors to
the plain version (``ref.flash_attention_ref``).  ``flash_attention.
launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192, 256)


def _lib():
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> tuple:
    """Raise unless q (B,S,H,D), k, v (B,S,KH,D) are contiguous CUDA
    tensors of one dtype that the attention kernels take; -> (b, s, h,
    kh, d)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} kernel takes CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes f32 or bf16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % kh:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous q, k, v")
    return b, s, h, kh, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KH, D) -> (B, S, H, D) in q's dtype.

    Any S: the ragged tail is masked inside the kernel.
    """
    b, s, h, kh, d = check_qkv("flash_attention", q, k, v, window)
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, h, kh, d, int(causal), window or 0, DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(rc, "flash_attention")
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
