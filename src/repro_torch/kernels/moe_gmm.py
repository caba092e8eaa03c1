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

``backward_plan`` chooses the bf16 backward kernels' tiling from the
shapes alone (no device needed); the wrappers pass it to the C entry
points, which check it.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build
from .flash_attention import DTYPES


# the int arguments of each entry point after its three pointers: E, C,
# d, f, dtype and its plan's numbers
_PLAN_INTS = {"expert_gemm": 0, "expert_gemm_dx": 3, "expert_gemm_dw": 3}


def _lib(name: str = "expert_gemm"):
    fn = getattr(build.load("moe_gmm"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p] + [i] * (5 + _PLAN_INTS[name]) + [p]
        fn.restype = ctypes.c_int
    return fn


# The backward kernels' tiling, as csrc/moe_gmm.cu defines it.
SMEM_MAX = 232448      # bytes of shared memory a block may take (H100)
BARRIERS = 256         # bytes of a block's shared memory kept for mbarriers
MAX_STAGES = 8
DX_ROWS = 128          # d rows of a dX block: two consumer warpgroups of 64
DX_MAX_N = 184         # the widest dX tile, two a block
DW_PANEL = 256         # d rows of x a dW block holds in shared memory
DW_TILE = 128          # f columns of a dW output tile
DW_K = 64              # C rows of a dW ring stage (32 the last at odd kp)
DW_MAX_KP = 384        # the largest panel (C rounded up to 32) beside 2 stages
# f32 sums a consumer thread holds at most: 232 registers a dX consumer
# thread (setmaxnreg; 48 for the rest); dW's, 168 of a 288-thread block,
# hold 128
SUM_BUDGET = 184
H100_SMS = 132


def _smem(payload: int) -> int:
    """Dynamic shared memory of a block: 1024 bytes of alignment slack,
    the payload and the mbarriers."""
    return 1024 + payload + BARRIERS


def _dx_stage(n: int) -> int:
    """One dX ring stage: two 64 x 64 w tiles and 2 n rows of 64 dy."""
    return 2 * 64 * 64 * 2 + 2 * n * 64 * 2


@dataclass(frozen=True)
class DxPlan:
    n: int            # wgmma N of each of the block's two C tiles
    groups: int       # blocks along C, each 2 n columns
    pad: int          # columns computed past C: 2 n groups - C
    stages: int       # 64-deep stages of the ring
    rows: int = DX_ROWS

    @property
    def smem(self) -> int:
        return _smem(self.stages * _dx_stage(self.n))

    @property
    def sums(self) -> int:
        """f32 sums a consumer thread holds: two tiles of 64 x n."""
        return self.n


@dataclass(frozen=True)
class DwPlan:
    persistent: bool  # False: the streaming kernel (C above DW_MAX_KP)
    kp: int = 0       # panel rows: C rounded up to 32
    stages: int = 0   # 64-row stages of the ring
    grid: int = 0     # persistent blocks, at most one per SM and per unit
    units: int = 0    # (expert, 256 d rows) panels, E ceil(d / 256)
    rows: int = DW_PANEL
    cols: int = DW_TILE

    @property
    def smem(self) -> int:
        return _smem(DW_PANEL * self.kp * 2 + self.stages * DW_K * DW_TILE
                     * 2)

    @property
    def sums(self) -> int:
        """f32 sums a consumer thread holds: two 64 x 128 tiles."""
        return 2 * 64 * DW_TILE // 128


def _dx_plan(c: int) -> DxPlan:
    """Blocks of two tiles of n columns, as few groups of them as cover C
    with fewer than 16 columns of padding (one up to C 368): w then
    streams through shared memory once per group.  Up to 4 stages, as
    shared memory allows (3 at n 176)."""
    groups = -(-c // (2 * DX_MAX_N))
    while True:
        n = 8 * -(-c // (16 * groups))       # 2 n groups >= c, n % 8 == 0
        if 2 * n * groups - c < 16:
            break
        groups += 1          # ends by groups = ceil(c / 16), where n = 8
    stages = min(4, (SMEM_MAX - _smem(0)) // _dx_stage(n))
    return DxPlan(n=n, groups=groups, pad=2 * n * groups - c, stages=stages)


def _dw_plan(e: int, c: int, d: int, sms: int) -> DwPlan:
    """Panels of 256 d rows by C rounded up to 32 rows; as many 64-row
    stages as fit beside the panel."""
    kp = 32 * -(-c // 32)
    if kp > DW_MAX_KP:
        return DwPlan(persistent=False)
    stages = min(MAX_STAGES, (SMEM_MAX - _smem(DW_PANEL * kp * 2))
                 // (DW_K * DW_TILE * 2))
    units = e * -(-d // DW_PANEL)
    return DwPlan(persistent=True, kp=kp, stages=stages,
                  grid=min(sms, units), units=units)


@functools.lru_cache(maxsize=256)
def backward_plan(e: int, c: int, d: int, f: int,
                  sms: int = H100_SMS) -> tuple:
    """The bf16 backward kernels' tiling for E experts of C rows, d -> f,
    on a card of ``sms`` SMs: -> (DxPlan, DwPlan).

    dX: a block takes 128 d rows and two C tiles of n columns (n a
    multiple of 8, at most 184), in as few groups along C as pad it by
    fewer than 16 columns; up to 4 stages 64 deep.  dW: a persistent grid of at
    most one block per SM takes the (expert, 256 d rows) units in turn,
    each block holding x's C panel of its unit (C rounded up to 32 rows)
    while the unit's 128-column f tiles of dy stream in 64-row stages;
    above 384 rows no panel fits and the streaming kernel runs.  Pure:
    the shapes alone decide it."""
    if min(e, c, d, f, sms) < 1:
        raise ValueError(f"bad shape E{e} C{c} d{d} f{f} on {sms} SMs")
    return _dx_plan(c), _dw_plan(e, c, d, sms)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    p = backward_plan(e, c, d, f, _sms(dy.device.index))[0]
    rc = _lib("expert_gemm_dx")(
        dy.data_ptr(), w.data_ptr(), dx.data_ptr(), e, c, d, f,
        DTYPES[dy.dtype], p.n, p.groups, p.stages,
        torch.cuda.current_stream(dy.device).cuda_stream)
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
    p = backward_plan(e, c, d, f, _sms(xe.device.index))[1]
    rc = _lib("expert_gemm_dw")(
        xe.data_ptr(), dy.data_ptr(), dw.data_ptr(), e, c, d, f,
        DTYPES[xe.dtype], p.kp, p.grid, p.stages,
        torch.cuda.current_stream(xe.device).cuda_stream)
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
