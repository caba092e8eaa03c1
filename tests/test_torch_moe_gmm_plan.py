"""The bf16 expert GEMM backward's tiling, ``moe_gmm.backward_plan``, on
the CPU: a pure function of the shapes, held at every training capacity
the port's MoE families produce and at the card check's edge cases to
the rules its kernels need (each wgmma N a multiple of 8 up to 256, C
padded by fewer than 16 columns, at most 232,448 bytes of shared memory
a block, sums within the consumers' registers) and to the tiling's own
bounds (the dX groups cover C with none empty, the dW grid at most one
block an SM and a unit, the panel beside two stages at least).
"""
import math

import pytest

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import moe_gmm as mg

MOE_FAMILIES = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                "qwen3-moe-235b-a22b")
DOC_LEN = 1024


def _capacity(cfg, tokens: int) -> int:
    """The folded C of ``moe_dense_dispatch`` for ``tokens`` tokens: groups
    of up to 1024 tokens, each of int(g k cf / E) rows (g when g <= 64),
    folded into one capacity axis under ``attn_impl="pallas"``."""
    m = cfg.moe
    g = min(1024, tokens)
    cap = max(1, int(g * m.top_k * m.capacity_factor / m.num_experts))
    if g <= 64:
        cap = g
    return -(-tokens // g) * cap


def _training_shapes():
    """(name, E, C, d, f) of each expert product a training step runs:
    the published configs at 1-16 documents of 1024 tokens, the smoke
    configs at 1-8 of 64 and 128 tokens; gate/up (d -> f) and down."""
    out = []
    for name in MOE_FAMILIES:
        for cfg, lens, docs in ((get_config(name), (DOC_LEN,), 16),
                                (get_smoke_config(name), (64, 128), 8)):
            e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
            for n in sorted({b * s for s in lens
                             for b in range(1, docs + 1)}):
                c = _capacity(cfg, n)
                out += [(name, e, c, d, f), (name, e, c, f, d)]
    return out


TRAINING = _training_shapes()
# phase 2's cases (chip_smoke.py GEMM_BWD_CASES and the families' training
# capacities): C 1, 255-257, 320, 340, 360, 1360; d and f off the 128-
# and 256-row tiles; E 1
EDGES = [(60, 340, 2048, 1408), (60, 340, 1408, 2048), (64, 240, 2048, 1408),
         (16, 320, 4096, 14336), (16, 320, 14336, 4096),
         (60, 1360, 2048, 1408), (2, 1, 136, 64), (1, 255, 200, 136),
         (2, 256, 136, 72), (2, 257, 136, 72), (1, 320, 200, 136),
         (2, 340, 72, 200), (1, 360, 200, 136), (1, 340, 264, 392),
         (3, 13, 200, 72), (2, 300, 200, 136), (2, 90, 72, 200)]


def _check(e, c, d, f, sms=mg.H100_SMS):
    dx, dw = mg.backward_plan(e, c, d, f, sms)
    # dX: two tiles of n columns a block in `groups` groups along C
    assert dx.n % 8 == 0 and 8 <= dx.n <= min(256, mg.DX_MAX_N), dx
    assert 0 <= dx.pad < 16 and dx.pad == 2 * dx.n * dx.groups - c, dx
    assert 2 * dx.n * (dx.groups - 1) < c, dx          # no empty group
    assert dx.smem <= mg.SMEM_MAX, dx
    # up to 4 stages, and the epilogue's staged rows in the ring
    assert 3 <= dx.stages <= 4, dx
    assert dx.stages == 4 or mg._smem(
        (dx.stages + 1) * mg._dx_stage(dx.n)) > mg.SMEM_MAX, dx
    assert 2 * dx.n * (dx.rows + 8) * 2 <= dx.stages * mg._dx_stage(dx.n)
    assert dx.sums <= mg.SUM_BUDGET, dx
    # dW: a persistent grid holding x's panel of kp rows, or streaming
    kp = 32 * math.ceil(c / 32)
    assert dw.persistent == (kp <= mg.DW_MAX_KP), dw
    if dw.persistent:
        assert dw.kp == kp and dw.kp - c < 32, dw
        units = e * math.ceil(d / mg.DW_PANEL)
        assert dw.units == units and dw.grid == min(sms, units), dw
        assert 2 <= dw.stages <= mg.MAX_STAGES, dw
        assert dw.smem <= mg.SMEM_MAX, dw
        assert dw.sums <= mg.SUM_BUDGET, dw
    else:
        assert dw.grid == 0, dw
    return dx, dw


@pytest.mark.parametrize("name", MOE_FAMILIES)
def test_plan_holds_at_every_training_capacity(name):
    shapes = [s[1:] for s in TRAINING if s[0] == name]
    assert len(shapes) >= 32
    for e, c, d, f in shapes:
        _check(e, c, d, f)


@pytest.mark.parametrize("e,c,d,f", EDGES)
def test_plan_holds_at_the_card_checks_edges(e, c, d, f):
    _check(e, c, d, f)


def test_plan_at_the_timed_shapes():
    """The timed shapes hold all of C in one block (w read once) as two
    tiles that pad by fewer than 16 (2 x 160, 2 x 176, 2 x 120), 4 stages
    but 3 at n 176; a persistent dW grid of one block an SM."""
    for (e, c, d, f), n, pad, stages in (
            ((16, 320, 4096, 14336), 160, 0, 4),
            ((60, 340, 2048, 1408), 176, 12, 3),
            ((64, 240, 2048, 1408), 120, 0, 4)):
        dx, dw = _check(e, c, d, f)
        assert (dx.n, dx.groups, dx.pad, dx.stages) == (n, 1, pad, stages)
        assert dw.persistent and dw.grid == mg.H100_SMS


def test_plan_is_pure_and_refuses_empty_shapes():
    assert mg.backward_plan(60, 340, 2048, 1408) == \
        mg.backward_plan.__wrapped__(60, 340, 2048, 1408)
    assert mg.backward_plan(8, 300, 600, 136, 4)[1].grid == 4
    for bad in ((0, 8, 64, 64), (1, 0, 64, 64), (1, 8, 64, 64, 0)):
        with pytest.raises(ValueError):
            mg.backward_plan(*bad)


def test_plan_splits_long_capacities_into_groups():
    """Above 368 columns dX takes several groups along C; dW streams above
    a panel of 384 rows."""
    dx, dw = _check(60, 1360, 2048, 1408)
    assert (dx.n, dx.groups, dx.pad) == (136, 5, 0) and not dw.persistent
    for c in range(369, 1500, 37):
        assert _check(4, c, 256, 256)[0].groups >= 2
