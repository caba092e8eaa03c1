"""The arithmetic of the bf16 SSD scan on the tensor cores
(``csrc/ssd_scan.cu``, ``csrc/ssd_common.cuh``), modelled on the CPU, where
the TPU kernel computes in f32:

* the chunk state takes x exact and B w_s (w_s = exp(cum_last - cum_s)
  dt_s) as bf16 hi + lo, so it keeps about 2^-16 of each term;
* the state carried across chunks stays f32; the output pass reads it as
  bf16 hi + lo;
* the intra-chunk scores C.B exp(cum_l - cum_s) dt_s are rounded to bf16
  once before their product with x (exact), as P in the attention
  kernels; y comes out in bf16.

The bf16 backward takes C e^{cum_l} (the chunk shares of the state
gradient) and S, dS as hi + lo in the same way, and rounds its scores
GE = (dy.x) dt_s exp(cum_l - cum_s) and CBE = (C.B) exp(cum_l - cum_s) to
bf16 once before their products into dC, dB and dxdt; dcum takes the f32
scores.

The model stays inside the card's bf16 bar (2e-2 of the largest output)
against the f32 plain version on the same bf16 inputs, and keeps the
final state within 1e-4 of its largest value (rounding B w to bf16 alone,
without its lo half, would not: shown below).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

BAR_BF16 = 2e-2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor) -> tuple:
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _chunks(x, dt, a, bm, cm, chunk):
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    nc, rep = s // chunk, h // g
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = bm.reshape(b, nc, chunk, g, n).repeat_interleave(rep, 3).float()
    Cc = cm.reshape(b, nc, chunk, g, n).repeat_interleave(rep, 3).float()
    cum = torch.cumsum(dtc * a.float(), dim=2)              # (b,nc,L,h)
    return xc, dtc, Bc, Cc, cum


def _tensor_core_ssd(x, dt, a, bm, cm, chunk, split_state=True):
    """-> (y as the bf16 kernel rounds it, final state f32)."""
    b, s, h, p = x.shape
    n = bm.shape[3]
    xc, dtc, Bc, Cc, cum = _chunks(x, dt, a, bm, cm, chunk)
    nc, L = s // chunk, chunk
    w = torch.exp(cum[:, :, -1:] - cum) * dtc                # (b,nc,L,h)
    bw = Bc * w[..., None]
    hi, lo = _split(bw) if split_state else (_bf16(bw), torch.zeros_like(bw))
    local = torch.einsum("bcshp,bcshn->bchpn", xc, hi) \
        + torch.einsum("bcshp,bcshn->bchpn", xc, lo)
    state = torch.zeros((b, h, p, n))
    starts = []
    for c in range(nc):
        starts.append(state)
        state = torch.exp(cum[:, c, -1])[..., None, None] * state \
            + local[:, c]
    shi, slo = _split(torch.stack(starts, 1))                # (b,nc,h,p,n)
    y_in = torch.exp(cum)[..., None] * (
        torch.einsum("bclhn,bchpn->bclhp", Cc, shi)
        + torch.einsum("bclhn,bchpn->bclhp", Cc, slo))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,nc,l,s,h)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, None, :,
                                                           :, None]
    decay = torch.exp(seg.masked_fill(~mask, -math.inf))
    cb = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc)
    m = _bf16(cb * decay * dtc[:, :, None])
    y = y_in + torch.einsum("bclsh,bcshp->bclhp", m, xc)
    return _bf16(y.reshape(b, s, h, p)), state


def _inputs(seed, b, s, h, p, g, n):
    """x / 8, dt = softplus(z - 2), A = -(1..H), grouped B and C scaled so
    that C.B is about 1, in bf16 (as chip_smoke.py's ssd_inputs)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    x = _bf16(f(b, s, h, p) / 8)
    dt = torch.nn.functional.softplus(f(b, s, h) - 2.0)
    a = -torch.arange(1, h + 1, dtype=torch.float32)
    bm, cm = (_bf16(f(b, s, g, n) * n ** -0.25) for _ in range(2))
    return x, dt, a, bm, cm


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# (B, S, H, P, G, N, chunk): mamba2-1.3b's widths at a short length, G = H,
# a chunk of 64 + 36 tokens, the routing prefix
CASES = [(1, 512, 8, 64, 1, 128, 256), (2, 96, 4, 32, 4, 64, 32),
         (2, 200, 4, 64, 2, 32, 100), (2, 32, 16, 64, 1, 128, 32)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_bf16_scores_and_split_states_stay_inside_the_bar(b, s, h, p, g, n,
                                                          chunk):
    x, dt, a, bm, cm = _inputs(0, b, s, h, p, g, n)
    y, state = _tensor_core_ssd(x, dt, a, bm, cm, chunk)
    py, pstate = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk)
    err = _rel(y, py)
    assert 0 < err <= BAR_BF16, err
    assert _rel(state, pstate) <= 1e-4, _rel(state, pstate)


def test_one_bf16_rounding_of_the_state_operand_would_cost_the_state():
    """Without B w's lo half the chunk state carries a bf16 rounding of
    every term (about 2^-9), above the state's f32 bar of 1e-4."""
    x, dt, a, bm, cm = _inputs(1, *CASES[0][:6])
    _, state = _tensor_core_ssd(x, dt, a, bm, cm, CASES[0][6],
                                split_state=False)
    _, pstate = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=CASES[0][6])
    assert _rel(state, pstate) > 1e-4


def _score_products(x, dt, a, bm, cm, dy, chunk, rounded):
    """The backward's intra-chunk products (dC, dB over each head; dxdt)
    with the scores rounded to bf16 or exact."""
    xc, dtc, Bc, Cc, cum = _chunks(x, dt, a, bm, cm, chunk)
    b, nc, L, h, p = xc.shape
    dyc = dy.reshape(b, nc, L, h, p).float()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,nc,l,s,h)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, None, :,
                                                           :, None]
    decay = torch.exp(seg.masked_fill(~mask, -math.inf))
    cb = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc)
    gg = torch.einsum("bclhp,bcshp->bclsh", dyc, xc) * dtc[:, :, None]
    ge, cbe = gg * decay, cb * decay
    if rounded:
        ge, cbe = _bf16(ge), _bf16(cbe)
    return (torch.einsum("bclsh,bcshn->bclhn", ge, Bc),
            torch.einsum("bclsh,bclhn->bcshn", ge, Cc),
            torch.einsum("bclsh,bclhp->bcshp", cbe, dyc))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES[:3])
def test_backward_roundings_stay_inside_the_bar(b, s, h, p, g, n, chunk):
    """The chunk shares of the state gradient from C e^{cum_l} as hi + lo
    (dy exact) keep 1e-5; the scores rounded to bf16 before dC, dB and
    dxdt, and the gradients' own bf16 rounding, keep dx, dB and dC within
    the bar of each one's largest value."""
    x, dt, a, bm, cm = _inputs(2, b, s, h, p, g, n)
    rng = np.random.default_rng(3)
    dy = _bf16(torch.from_numpy(
        rng.standard_normal((b, s, h, p)).astype(np.float32)))
    _, _, _, Cc, cum = _chunks(x, dt, a, bm, cm, chunk)
    dyc = dy.reshape(b, s // chunk, chunk, h, p)
    cw = Cc * torch.exp(cum)[..., None]
    hi, lo = _split(cw)
    split = torch.einsum("bclhp,bclhn->bchpn", dyc, hi + lo)
    exact = torch.einsum("bclhp,bclhn->bchpn", dyc, cw)
    assert _rel(split, exact) <= 1e-5
    dx, _, _, dB, dC = ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, None,
                                            chunk=chunk)
    # the model: the exact gradients plus what rounding the scores moves
    got = _score_products(x, dt, a, bm, cm, dy, chunk, True)
    want = _score_products(x, dt, a, bm, cm, dy, chunk, False)
    moved = [u - v for u, v in zip(got, want)]
    rep = h // g
    dx_m = dx + (moved[2] * dt.reshape(moved[2].shape[:-1])[..., None]
                 ).reshape(dx.shape)
    dC_m = dC + moved[0].reshape(b, s, g, rep, n).sum(3)
    dB_m = dB + moved[1].reshape(b, s, g, rep, n).sum(3)
    for name, model, exact_g in (("dx", dx_m, dx), ("dB", dB_m, dB),
                                 ("dC", dC_m, dC)):
        err = _rel(_bf16(model), exact_g)
        assert 0 < err <= BAR_BF16, (name, err)
