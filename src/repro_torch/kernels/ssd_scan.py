"""Mamba2 SSD chunked scan: wrappers of the CUDA kernels, and the autograd
Function that joins them.

  ssd_scan      csrc/ssd_scan.cu; replaces the TPU kernel
                ``repro/kernels/ssd_scan.py:61 ssd_scan``; on request it
                also returns the f32 state at each chunk's start
  ssd_scan_bwd  csrc/ssd_scan_bwd.cu; the TPU package has no backward
                kernel (its models differentiate ``ssd_chunked``)

They take CUDA tensors only and count their launches (``.launches``).
``SSDScan`` reaches them through ``ops``, which sends CPU tensors to the
plain versions (``ref.ssd_scan_ref``, ``ref.ssd_scan_bwd_ref``), so the
Function is the same on both devices.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attention import DTYPES

HEAD_DIMS = (32, 64)
STATE_DIMS = (32, 64, 128)
MAX_CHUNK = 256


def _fn(lib: str, n_ptr: int, n_int: int):
    fn = getattr(build.load(lib), lib)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    return fn


def _work_bytes():
    fn = build.load("ssd_scan_bwd").ssd_scan_bwd_work_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_long
    return fn


def _check(name, x, dt, a, bmat, cmat, chunk) -> tuple:
    """Raise unless the inputs are contiguous CUDA tensors of the shapes,
    dtypes and widths the kernels take; -> (b, s, h, g, p, n)."""
    ts = (x, dt, a, bmat, cmat)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError(f"{name} kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    if x.dtype not in DTYPES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        raise TypeError(f"{name} takes f32 or bf16 x, B, C of one dtype, "
                        f"got {x.dtype}, {bmat.dtype}, {cmat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"{name} takes f32 dt and A, got {dt.dtype}, "
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
        raise ValueError(f"{name} takes contiguous x, dt, A, B, C")
    return b, s, h, g, p, n


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
             states: bool = False) -> tuple:
    """x (B,S,H,P) f32 or bf16; dt (B,S,H) f32; a (H,) f32; bmat, cmat
    (B,S,G,N) in x's dtype, H % G == 0; S % chunk == 0, chunk <= 256 ->
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32), and with
    ``states`` also the f32 state at each chunk's start (B,S/chunk,H,P,N)
    (zeros for the first), which ``ssd_scan_bwd`` takes."""
    b, s, h, g, p, n = _check("ssd_scan", x, dt, a, bmat, cmat, chunk)
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), **f32)
    bf16 = x.dtype == torch.bfloat16
    starts = hilo = cum_last = cumdt = None
    if bf16 or states:
        # the start states (f32), also scratch of the three passes (bf16)
        starts = torch.empty((b, nc, h, p, n), **f32)
    if bf16:
        cum_last = torch.empty((b, nc, h), **f32)
        hilo = torch.empty((2, b, nc, h, p, n), dtype=torch.bfloat16,
                           device=x.device)
        cumdt = torch.empty((b, nc, h, 2, MAX_CHUNK), **f32)
    rc = _fn("ssd_scan", 11, 9)(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), y.data_ptr(), final.data_ptr(), _ptr(starts),
        _ptr(hilo), _ptr(cum_last), _ptr(cumdt), b, s, h, g, p, n, chunk,
        DTYPES[x.dtype], int(states),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "ssd_scan")
    build.count_launch(ssd_scan)
    return (y, final, starts) if states else (y, final)


def ssd_scan_bwd(x, dt, a, bmat, cmat, dy, dstate, starts, *,
                 chunk: int) -> tuple:
    """The scan's backward: the forward's inputs, dy (B,S,H,P) in x's
    dtype, the final state's gradient (B,H,P,N) f32 or None, and the
    start states ``ssd_scan(..., states=True)`` returned -> (dx, ddt, da,
    dB, dC) in the dtypes of x, dt, a, bmat, cmat."""
    b, s, h, g, p, n = _check("ssd_scan_bwd", x, dt, a, bmat, cmat, chunk)
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"ssd_scan_bwd: dy must be contiguous like x, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    for t, what, shape in ((dstate, "dstate", (b, h, p, n)),
                           (starts, "starts", (b, nc, h, p, n))):
        if t is None and what == "dstate":
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ssd_scan_bwd: {what} must be contiguous f32 "
                             f"{shape} on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da = torch.empty((h,), **f32)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    dstates = torch.empty((b, nc, h, p, n), **f32)
    cum_last = torch.empty((b, nc, h), **f32)
    per_head = torch.empty((2, b, s, h, n), **f32)
    da_part = torch.empty((b, nc, h), **f32)
    work = None
    if x.dtype == torch.bfloat16:
        # the tensor-core route's scratch: cum and dt, token rows, S and
        # dS as bf16 hi and lo
        work = torch.empty((_work_bytes()(b, s, h, p, n, chunk),),
                           dtype=torch.uint8, device=x.device)
    rc = _fn("ssd_scan_bwd", 18, 8)(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), dy.data_ptr(), _ptr(dstate), starts.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
        dc.data_ptr(), dstates.data_ptr(), cum_last.data_ptr(),
        per_head.data_ptr(), da_part.data_ptr(), _ptr(work), b, s, h, g, p,
        n, chunk, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, "ssd_scan_bwd")
    build.count_launch(ssd_scan_bwd)
    return dx, ddt, da, db, dc


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """Differentiable SSD scan: the forward keeps each chunk's start state
    (on the card; the CPU's plain backward recomputes them), the backward
    is ``ssd_scan_bwd``.  -> (y, final state), both differentiable."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk: int):
        from . import ops
        ctx.dtypes = (dt.dtype, a.dtype)
        x, bmat, cmat = (t.contiguous() for t in (x, bmat, cmat))
        dt, a = dt.float().contiguous(), a.float().contiguous()
        y, final, starts = ops.ssd_scan_fwd_states(x, dt, a, bmat, cmat,
                                                   chunk=chunk)
        ctx.save_for_backward(x, dt, a, bmat, cmat, starts)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dstate):
        from . import ops
        x, dt, a, bmat, cmat, starts = ctx.saved_tensors
        dy = (torch.zeros_like(x) if dy is None
              else dy.contiguous().to(x.dtype))
        if dstate is not None:
            dstate = dstate.float().contiguous()
        dx, ddt, da, db, dc = ops.ssd_scan_bwd(
            x, dt, a, bmat, cmat, dy, dstate, starts, chunk=ctx.chunk)
        return (dx, ddt.to(ctx.dtypes[0]), da.to(ctx.dtypes[1]), db, dc,
                None)
