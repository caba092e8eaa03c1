"""k-means assignment (paper Eq. 1): wrapper of the CUDA kernel
``csrc/router_assign.cu`` (replaces the TPU kernel
``repro/kernels/router_assign.py:29 router_assign``).

The products run on the tensor cores (f32 as 3xTF32, bf16 as it is),
after a small kernel that writes the centroids' TF32 tables and norms
into one workspace; rows whose width TMA cannot load (D not a multiple
of 4 in f32, 8 in bf16) take a CUDA-core kernel.  Takes CUDA tensors
only; ``ops.router_assign`` sends CPU tensors to the plain version
(``ref.router_assign_ref``).  ``router_assign.launches`` counts the
calls that launch the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attention import DTYPES


def _lib():
    fn = build.load("router_assign").router_assign
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def router_assign(z: torch.Tensor, centroids: torch.Tensor) -> tuple:
    """z (N, D), centroids (K, D), f32 or bf16 -> (assign (N,) int32,
    min d2 (N,) f32); ties go to the first centroid."""
    if not (z.is_cuda and centroids.device == z.device):
        raise ValueError("router_assign kernel takes CUDA tensors on one "
                         f"device, got {z.device}, {centroids.device}")
    if z.dtype not in DTYPES or centroids.dtype != z.dtype:
        raise TypeError(f"router_assign takes f32 or bf16 z and centroids of "
                        f"one dtype, got {z.dtype}, {centroids.dtype}")
    if z.ndim != 2 or centroids.ndim != 2 \
            or centroids.shape[1] != z.shape[1]:
        raise ValueError(f"bad shapes z {tuple(z.shape)}, centroids "
                         f"{tuple(centroids.shape)}")
    n, d = z.shape
    k = centroids.shape[0]
    if n < 1 or k < 1 or d < 1:
        raise ValueError(f"empty input: z {tuple(z.shape)}, centroids "
                         f"{tuple(centroids.shape)}")
    if not (z.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("router_assign takes contiguous z and centroids")
    assign = torch.empty(n, dtype=torch.int32, device=z.device)
    mind2 = torch.empty(n, dtype=torch.float32, device=z.device)
    # the centroids' TF32 hi and lo tables (f32) and their norms
    work = torch.empty(2 * k * d + k if z.dtype == torch.float32 else k,
                       dtype=torch.float32, device=z.device)
    rc = _lib()(z.data_ptr(), centroids.data_ptr(), assign.data_ptr(),
                mind2.data_ptr(), work.data_ptr(), n, k, d, DTYPES[z.dtype],
                torch.cuda.current_stream(z.device).cuda_stream)
    build.check_rc(rc, "router_assign")
    build.count_launch(router_assign)
    return assign, mind2


router_assign.launches = 0
