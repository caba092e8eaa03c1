"""Mamba2 SSD chunked scan: wrapper of the CUDA kernel
``csrc/ssd_scan.cu`` (replaces the TPU kernel
``repro/kernels/ssd_scan.py:61 ssd_scan``).

Takes CUDA tensors only; ``ops.ssd_scan`` sends CPU tensors to the plain
version (``ref.ssd_scan_ref``).  ``ssd_scan.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attention import DTYPES

HEAD_DIMS = (32, 64)
STATE_DIMS = (32, 64, 128)
MAX_CHUNK = 256


def _lib():
    fn = build.load("ssd_scan").ssd_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int) -> tuple:
    """x (B,S,H,P) f32 or bf16; dt (B,S,H) f32; a (H,) f32; bmat, cmat
    (B,S,G,N) in x's dtype, H % G == 0; S % chunk == 0, chunk <= 256 ->
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    ts = (x, dt, a, bmat, cmat)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError("ssd_scan kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    if x.dtype not in DTYPES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes f32 or bf16 x, B, C of one dtype, "
                        f"got {x.dtype}, {bmat.dtype}, {cmat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes f32 dt and A, got {dt.dtype}, "
                        f"{a.dtype}")
    if x.ndim != 4 or bmat.ndim != 4 or bmat.shape != cmat.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, B "
                         f"{tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if dt.shape != (b, s, h) or a.shape != (h,) \
            or bmat.shape[:2] != (b, s) or h % g:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(a.shape)}, B "
                         f"{tuple(bmat.shape)}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"head_dim {p} not in {HEAD_DIMS} or d_state {n} "
                         f"not in {STATE_DIMS}")
    if not (1 <= chunk <= MAX_CHUNK) or s < 1 or s % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide S = {s}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan takes contiguous x, dt, A, B, C")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    rc = _lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                cmat.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, g,
                p, n, chunk, DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
