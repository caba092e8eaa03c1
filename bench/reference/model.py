"""What every architecture's plain reference shares: f32 without TF32
(``precise``), the float8 rounding of the control (``FP8MatMul``), and
the lookup of an architecture's reference by name.

An architecture's reference is ``reference/<arch_type>.py``, found by
the configuration's ``arch_type`` (the port's ``ModelConfig`` field):
it holds ``leaf_specs(m)``, the weight layout the benchmark draws, and
``Model(params, m, precision)`` with ``logits``, ``nll_sum`` and
``features``.  A configuration of another architecture brings that
file; nothing here names one.
"""
from __future__ import annotations

import importlib

import torch

FP8_MAX = 448.0


def precise() -> None:
    """f32 products in f32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (amax -> 448), back
    in f32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class FP8MatMul(torch.autograd.Function):
    """``a @ b`` with both inputs rounded to float8, and in the backward
    the incoming gradient too: every product of the forward and the
    backward takes float8 inputs (f32 sums)."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = fp8_round(g)
        ga = torch.matmul(g8, b8.transpose(-1, -2))
        gb = torch.matmul(a8.transpose(-1, -2), g8)
        # undo broadcasting over leading axes
        while ga.dim() > a8.dim():
            ga = ga.sum(0)
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        return ga, gb


def family(m: dict):
    """The reference module of the configuration ``m``'s architecture:
    ``bench/reference/<arch_type>.py``."""
    return importlib.import_module(f"bench.reference.{m['arch_type']}")


def build(params: dict, m: dict, precision: str = "f32"):
    """The architecture's reference model over the flat f32 ``params``;
    ``precision="fp8"`` is the control."""
    if precision not in ("f32", "fp8"):
        raise ValueError(precision)
    return family(m).Model(params, m, precision)
