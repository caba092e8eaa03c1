"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Every test carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is absent, e.g. on the H100 machine:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

# f32: summation order only; bf16: one bf16 rounding of outputs below 4
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# (B, H, KH, D, T, cache_index, window): MHA, GQA, MQA, ring wrap,
# window over a wrapped ring, non-power-of-2 T, D 128
DECODE_CASES = [
    (2, 4, 4, 32, 32, [5, 20], None),
    (3, 8, 2, 64, 64, [0, 31, 63], None),
    (2, 4, 1, 32, 48, [10, 40], None),
    (2, 4, 2, 32, 32, [40, 70], None),
    (2, 4, 2, 32, 32, [12, 45], 8),
    (2, 4, 2, 32, 40, [7, 90], 12),
    (3, 16, 2, 128, 300, [0, 299, 1000], 100),
    (8, 16, 16, 128, 80, [79] * 8, None),      # a qwen2-moe decode step
    # one (b, kh) row over a long cache: several splits, which meet at the
    # arrival counter (MHA, GQA with a window over a wrapped ring, MQA)
    (1, 8, 8, 64, 2048, [2047], None),
    (1, 16, 2, 128, 2048, [3000], 700),
    (1, 4, 1, 32, 2048, [5000], None),
    # the last three families' query groups and head dims, in head groups
    # of two query heads a block (G 5 at D 256: 2 + 2 + 1), also over
    # several splits
    (3, 8, 1, 256, 80, [79, 10, 200], None),
    (2, 24, 2, 192, 80, [40, 79], None),
    (2, 32, 2, 128, 80, [79, 100], 32),
    (2, 10, 2, 256, 64, [7, 63], None),
    (1, 12, 1, 192, 2048, [2047], None),
    (1, 16, 1, 128, 2048, [3000], 700),
]
# (B, S, H, KH, D, window): MHA, GQA, MQA, windows, ragged S, and the
# edges of the bf16 tensor-core tiling: S 1 and 65 (a tail of one row, a
# second tile of one key), S 333 over several key tiles, each D (the
# 64-byte swizzle at 32, two column boxes at 128) under windows and GQA
ATTN_CASES = [
    (2, 64, 4, 4, 32, None),
    (2, 64, 8, 2, 32, None),
    (1, 48, 4, 1, 64, None),
    (2, 64, 4, 2, 32, 16),
    (2, 50, 4, 2, 32, None),
    (1, 77, 4, 4, 128, 24),
    (8, 32, 16, 16, 128, None),                # qwen2-moe's routing prefix
    (2, 1, 4, 2, 64, None),
    (2, 65, 4, 2, 64, None),
    (1, 65, 8, 2, 32, 16),
    (2, 65, 4, 4, 128, 7),
    (1, 333, 4, 1, 32, None),
    (2, 333, 8, 2, 64, 100),
    (1, 333, 8, 2, 128, 100),
    # D 192 and 256: 3 and 4 column boxes a row, GQA 12 and MQA
    (2, 32, 8, 1, 256, None),
    (1, 333, 12, 1, 192, 100),
    (2, 65, 4, 1, 256, 7),
    (1, 130, 24, 2, 192, None),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def _quant(x):
    scale = torch.clamp_min(x.abs().amax(-1) / 127.0, 1e-8)
    qx = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return qx.to(torch.int8), scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,window", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, h, kh, d,
                                              window):
    """Both instantiations of the forward kernel: the serving one, and the
    training one with its LSE rows."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_lse
    q, k, v = (x.to(cuda, dtype) for x in _randn(
        5, (b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    before = flash_attention.launches, flash_attention_lse.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    o, lse = flash_attention_lse(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_lse.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    plain = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=0)
    po, plse = ref.fwd_with_lse_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,d,T,ci,window", DECODE_CASES)
def test_flash_decode_kernel_matches_plain(cuda, dtype, int8, b, h, kh, d, T,
                                           ci, window):
    from repro_torch.kernels.decode_attention import flash_decode
    q, kc, vc = _randn(6, (b, h, d), (b, T, kh, d), (b, T, kh, d))
    ks = vs = None
    if int8:
        (kc, ks), (vc, vs) = _quant(kc), _quant(vc)
        ks, vs = ks.to(cuda), vs.to(cuda)
        kc, vc = kc.to(cuda), vc.to(cuda)
    else:
        kc, vc = kc.to(cuda, dtype), vc.to(cuda, dtype)
    q = q.to(cuda, dtype)
    cit = torch.tensor(ci, dtype=torch.int32, device=cuda)
    before = flash_decode.launches
    out = flash_decode(q, kc, vc, cit, window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    plain = ref.flash_decode_ref(q, kc, vc, cit, window=window, k_scale=ks,
                                 v_scale=vs)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=0)


def _decode_inputs(cuda, b, h, kh, d, T, ci, dtype=torch.bfloat16):
    q, kc, vc = _randn(7, (b, h, d), (b, T, kh, d), (b, T, kh, d))
    return (q.to(cuda, dtype), kc.to(cuda, dtype), vc.to(cuda, dtype),
            torch.tensor(ci, dtype=torch.int32, device=cuda))


def _device_kernels(fn) -> list:
    """Names of the device kernels that one call of fn runs."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name().lower()
            and "memset" not in e.name().lower()]


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,ci", [(8, 80, [79] * 8), (1, 2048, [2047])])
def test_flash_decode_is_one_kernel_a_call(cuda, b, T, ci):
    """One split (the serving step) and several (the last split combines):
    each call runs exactly one device kernel."""
    from repro_torch.kernels.decode_attention import flash_decode
    q, kc, vc, cit = _decode_inputs(cuda, b, 16, 16, 64, T, ci)
    flash_decode(q, kc, vc, cit)            # first use: the counters
    kernels = _device_kernels(lambda: flash_decode(q, kc, vc, cit))
    assert len(kernels) == 1 and "decode_kernel" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,ci", [(8, 80, [79] * 8), (1, 2048, [3000])])
def test_flash_decode_replays_from_a_cuda_graph(cuda, b, T, ci):
    """No host sync in the call: it captures, and three replays give the
    eager call's bits (the arrival counters return to 0 each time)."""
    from repro_torch.kernels.decode_attention import flash_decode
    q, kc, vc, cit = _decode_inputs(cuda, b, 16, 4, 64, T, ci)
    eager = flash_decode(q, kc, vc, cit, window=1000)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        flash_decode(q, kc, vc, cit, window=1000)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash_decode(q, kc, vc, cit, window=1000)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_flash_decode_shared_memory_fits_a_block(cuda):
    """Every instantiation's dynamic shared memory fits the 232,448 bytes
    a block may take; an unknown head dim has none."""
    from repro_torch.kernels import decode_attention as da
    for d in da.HEAD_DIMS:
        for t in (torch.float32, torch.bfloat16, torch.int8):
            for g in range(1, da.MAX_GROUP + 1):
                assert 0 < da.smem_bytes(d, t, g) <= 232448, (d, t, g)
    with pytest.raises(ValueError, match="no instantiation"):
        da.smem_bytes(96, torch.bfloat16, 1)


@pytest.mark.cuda
def test_model_decode_goes_through_both_kernels(cuda):
    """The wiring at smoke size: the pallas model's cache-free forward
    launches flash attention once per block, a decode step flash decode
    once per block, and prefill neither (its dense s > 1 branch)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import api
    cfg = get_smoke_config("dipaco-150m").replace(attn_impl="pallas")
    params = api.init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda)
    fa, fd = flash_attention.launches, flash_decode.launches
    api.forward_logits(params, cfg, {"tokens": toks})
    _, cache = api.prefill(params, cfg, {"tokens": toks}, 16)
    assert flash_decode.launches == fd
    logits, _ = api.serve_step(params, cfg, {"tokens": toks[:, :1]}, cache, 8)
    torch.cuda.synchronize()
    assert flash_attention.launches == fa + cfg.num_layers
    assert flash_decode.launches == fd + cfg.num_layers
    assert torch.isfinite(logits).all()


# the backward cases of tests/test_kernels.py (B=2, causal and not, ragged
# S, a non-causal GQA window), the other head dims, a long ragged S over
# several tiles, the edges of the bf16 tensor-core tiling (S 1; S 65, a
# second tile of one row, at D 128 under a window and at D 32 with GQA G
# 4, not causal), the training shape, and the last three families' heads
# (D 256 G 8, D 192 G 12 under a window, D 128 G 16; ragged S over the
# column chunks of dK/dV at D 192 and 256, and the 32-row f32 tiles at
# D 256): (B, S, H, KH, D, causal, window)
BWD_CASES = [
    (2, 128, 4, 2, 32, True, None),
    (2, 96, 2, 1, 64, True, 24),
    (2, 64, 4, 4, 32, False, None),
    (2, 80, 2, 2, 32, True, None),
    (2, 64, 4, 2, 32, False, 16),
    (2, 200, 4, 4, 128, True, None),
    (2, 333, 8, 2, 64, True, 100),
    (2, 1, 4, 2, 64, True, None),
    (2, 65, 4, 2, 128, True, 7),
    (2, 65, 8, 2, 32, False, None),
    (8, 1024, 16, 16, 64, True, None),
    (2, 200, 8, 1, 256, True, None),
    (2, 333, 24, 2, 192, True, 100),
    (1, 65, 16, 1, 128, True, None),
    (2, 65, 4, 2, 256, False, 7),
    (1, 1, 12, 1, 192, True, None),
]
# gradients: f32 differs by summation order only; bf16 by one bf16
# rounding of each output, relative to the largest gradient
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", BWD_CASES)
def test_training_attention_kernels_match_plain(cuda, dtype, b, s, h, kh, d,
                                                causal, window):
    """The LSE forward, dK/dV and dQ kernels against their plain
    versions on the same inputs."""
    from repro_torch.kernels.flash_attention_bwd import (
        attention_delta, dkv_launches, flash_attention_dkv,
        flash_attention_dq, flash_attention_lse)
    q, k, v, do = (x.to(cuda, dtype) for x in _randn(
        7, (b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))
    counts = (flash_attention_lse.launches, flash_attention_dkv.launches,
              flash_attention_dq.launches)
    o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    po, plse = ref.fwd_with_lse_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    delta = attention_delta(do, po)
    dk, dv = flash_attention_dkv(q, k, v, do, plse, delta, causal=causal,
                                 window=window)
    dq = flash_attention_dq(q, k, v, do, plse, delta, causal=causal,
                            window=window)
    torch.cuda.synchronize()
    assert (flash_attention_lse.launches, flash_attention_dkv.launches,
            flash_attention_dq.launches) == tuple(
        c + n for c, n in zip(counts, (1, dkv_launches(dtype, d), 1)))
    plain = ref.flash_attention_bwd_ref(q, k, v, po, plse, do, causal=causal,
                                        window=window)
    for name, a, p in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        assert a.dtype == dtype and a.shape == p.shape, name
        if s == 1 and name != "dv":
            # one key: P is 1 and dP equals delta, so dS, dq and dk are
            # zero but for rounding, where an error relative to the
            # largest value would compare rounding with rounding
            assert a.float().abs().max() <= TOL[dtype], name
        else:
            assert _rel_err(a, p) <= GRAD_TOL[dtype], (name, _rel_err(a, p))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (2, 333, 8, 2, 64, True, 100), (2, 65, 4, 2, 128, True, 7),
    (2, 65, 8, 2, 32, False, None), (2, 200, 8, 1, 256, True, None),
    (2, 333, 24, 2, 192, True, 100), (1, 130, 64, 4, 128, True, None)])
def test_bf16_backward_kernels_are_bit_identical_across_launches(
        cuda, b, s, h, kh, d, causal, window):
    """Every block owns its output rows (no atomics), so two launches on
    the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention_bwd import (
        attention_delta, flash_attention_dkv, flash_attention_dq)
    q, k, v, do = (x.to(cuda, torch.bfloat16) for x in _randn(
        12, (b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))
    o, lse = ref.fwd_with_lse_ref(q, k, v, causal=causal, window=window)
    delta = attention_delta(do, o)
    runs = [(*flash_attention_dkv(q, k, v, do, lse, delta, causal=causal,
                                  window=window),
             flash_attention_dq(q, k, v, do, lse, delta, causal=causal,
                                window=window)) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, c in zip(("dk", "dv", "dq"), *runs):
        assert torch.equal(a, c), name


# (N, D, K): ragged N, one and several centroid tiles of each width (K 1,
# 4, 16, 70, 256 and 257: two tiles of 192), D 36 (f32 on TMA; bf16 on
# the CUDA cores), D 50 (the CUDA-core kernel in both types) and the
# paper's table at N 4096
ASSIGN_CASES = [(513, 32, 8), (1000, 64, 16), (256, 128, 4), (300, 96, 70),
                (4096, 896, 256), (777, 896, 1), (2048, 896, 4),
                (1000, 128, 257), (333, 36, 24), (200, 50, 40),
                (131, 64, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", ASSIGN_CASES)
def test_router_assign_kernel_matches_plain(cuda, dtype, n, d, k):
    """Same argmin except where the two best distances lie within 1e-5
    of the distance scale (summation orders differ); min d2 likewise."""
    from repro_torch.core.routing.kmeans import squared_distances
    from repro_torch.kernels.router_assign import router_assign
    z, c = (x.to(cuda, dtype) for x in _randn(8, (n, d), (k, d)))
    a, d2 = router_assign(z, c)
    pa, pd2 = ref.router_assign_ref(z, c)
    torch.cuda.synchronize()
    full = squared_distances(z, c)
    scale = float(full.abs().max())
    top2 = torch.topk(-full, min(2, k), dim=-1).values
    gap = (top2[:, 0] - top2[:, -1]).abs()
    differ = a != pa
    assert bool((gap[differ] <= 1e-5 * scale).all())
    assert float(differ.float().mean()) <= 1e-3
    torch.testing.assert_close(d2, pd2, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", [(1000, 64, 16), (300, 96, 300)])
def test_router_assign_ties_go_to_the_first_index(cuda, dtype, n, d, k):
    """Small integers: every product and sum is exact in TF32, bf16 and
    f32, so the distances are exact and many tie; the argmin is numpy's
    (the first of equal minima), and a repeated centroid never wins."""
    from repro_torch.kernels.router_assign import router_assign
    rng = np.random.default_rng(9)
    z = rng.integers(-2, 3, (n, d))
    c = rng.integers(-1, 2, (k, d))
    c[k // 2] = c[1]                          # an exact duplicate
    d2 = ((z[:, None, :] - c[None]) ** 2).sum(-1)
    a, m = router_assign(torch.tensor(z, dtype=dtype, device=cuda),
                         torch.tensor(c, dtype=dtype, device=cuda))
    torch.cuda.synchronize()
    assert np.array_equal(a.cpu().numpy(), d2.argmin(-1))
    assert np.array_equal(m.cpu().numpy(), d2.min(-1).astype(np.float32))
    assert not bool((a == k // 2).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_router_assign_nan_row_gets_index_0_and_relaunch_is_exact(cuda,
                                                                  dtype):
    from repro_torch.kernels.router_assign import router_assign
    z, c = (x.to(cuda, dtype) for x in _randn(10, (300, 128), (20, 128)))
    z[7] = float("nan")
    a, m = router_assign(z, c)
    a2, m2 = router_assign(z, c)
    torch.cuda.synchronize()
    assert int(a[7]) == 0 and not bool(torch.isfinite(m[7]))
    pa, _ = ref.router_assign_ref(z, c)
    rows = torch.arange(300, device=cuda) != 7
    assert float((a != pa)[rows].float().mean()) <= 1e-3
    assert torch.equal(a, a2) and torch.equal(m, m2)


@pytest.mark.cuda
def test_pallas_loss_backward_reaches_attention_weights(cuda):
    """loss.backward() through attn_impl="pallas" (FlashAttention: LSE
    forward, dK/dV and dQ kernels) gives every leaf, wq/wk/wv among them,
    the plain path's gradient; bf16, relative to the largest gradient of
    each leaf, within 3e-2 (a few bf16 roundings through 2 blocks)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_dkv,
                                                         flash_attention_dq)
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves
    cfg = get_smoke_config("dipaco-150m").replace(dtype="bfloat16",
                                                  route_prefix_len=8)
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    grads = {}
    for impl in ("pallas", "full"):
        params = api.init_model(cfg, seed=0, device=cuda)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        before = flash_attention_dkv.launches, flash_attention_dq.launches
        loss, _ = api.forward_loss(params, cfg.replace(attn_impl=impl),
                                   {"tokens": toks})
        loss.backward()
        launched = (flash_attention_dkv.launches - before[0],
                    flash_attention_dq.launches - before[1])
        assert launched == ((cfg.num_layers,) * 2 if impl == "pallas"
                            else (0, 0))
        grads[impl] = params["blocks"]["pos0"]["mixer"]
    for name in ("wq", "wk", "wv", "wo"):
        a = grads["pallas"][name].grad
        b = grads["full"][name].grad
        assert a is not None and float(a.float().abs().max()) > 0, name
        assert _rel_err(a, b) <= 3e-2, (name, _rel_err(a, b))


# ---------------------------------------------------------------------------
# The SSD scan and the expert GEMM (the SSM and token-MoE families)
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, b, s, h, p, g, n):
    """x / 4, dt = softplus(z - 2), A = -(1..H) as the model's A_log
    gives it, and grouped B, C scaled so that C . B is about 1: outputs
    stay below 4, where one bf16 rounding is within TOL."""
    x, z, bm, cm = _randn(seed, (b, s, h, p), (b, s, h), (b, s, g, n),
                          (b, s, g, n))
    dt = torch.nn.functional.softplus(z - 2.0)
    a = -torch.arange(1, h + 1, dtype=torch.float32)
    return x / 4, dt, a, bm * n ** -0.25, cm * n ** -0.25


# (B, S, H, P, G, N, chunk): several chunks, groups, the routing
# prefix, a 6-token prompt (chunk 6), a ragged last tile (chunk 100),
# the full width at a short length; then the edges of the bf16
# tensor-core passes: G = H, chunk 32 / 64 / 256 over several chunks,
# each P and N, a chunk that is not a multiple of 64 tokens (l tiles of
# 64 + 36), and head slices of 8 sharing one group's C B^T
SSD_CASES = [
    (2, 128, 4, 32, 1, 32, 64),
    (2, 96, 6, 64, 3, 64, 32),
    (8, 32, 8, 64, 1, 128, 32),
    (2, 6, 4, 64, 1, 128, 6),
    (2, 200, 4, 64, 2, 128, 100),
    (1, 512, 64, 64, 1, 128, 256),
    (2, 96, 4, 32, 4, 64, 32),
    (1, 768, 16, 32, 1, 128, 256),
    (2, 300, 8, 64, 8, 32, 100),
    (1, 256, 16, 64, 2, 64, 64),
    (3, 64, 4, 32, 2, 32, 64),
]
# backward cases: mamba2-1.3b's training shape (B4 S1024), then the same
# edges at smaller sizes
SSD_BWD_CASES = [
    (4, 1024, 64, 64, 1, 128, 256),
    (2, 128, 4, 32, 1, 32, 64),
    (2, 96, 6, 64, 3, 64, 32),
    (2, 200, 4, 64, 2, 128, 100),
    (1, 512, 16, 64, 1, 128, 256),
    (2, 96, 4, 32, 4, 64, 32),
    (2, 6, 4, 64, 1, 128, 6),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, dtype, b, s, h, p, g, n,
                                       chunk):
    """y and the final state against the plain chunked SSD on the same
    inputs (both f32 inside; bf16 y differs by one output rounding)."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    x, dt, a, bm, cm = _ssd_inputs(9, b, s, h, p, g, n)
    x, bm, cm = (t.to(cuda, dtype) for t in (x, bm, cm))
    dt, a = dt.to(cuda), a.to(cuda)
    before = ssd_scan.launches
    y, state = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    py, pstate = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk)
    assert y.dtype == dtype and y.shape == x.shape
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    assert float(py.float().abs().max()) < 4
    torch.testing.assert_close(y.float(), py.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(state, pstate, atol=1e-4, rtol=0)
    # the start states the backward takes: chunk c's is the final state
    # of the first c chunks
    y2, state2, starts = ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                  states=True)
    assert torch.equal(y2, y) and torch.equal(state2, state)
    assert starts.shape == (b, s // chunk, h, p, n)
    assert float(starts[:, 0].abs().max()) == 0
    for c in range(1, s // chunk):
        _, want = ref.ssd_scan_ref(x[:, :c * chunk], dt[:, :c * chunk], a,
                                   bm[:, :c * chunk], cm[:, :c * chunk],
                                   chunk=chunk)
        torch.testing.assert_close(starts[:, c], want, atol=1e-4, rtol=0)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("final_grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_BWD_CASES)
def test_ssd_scan_bwd_kernel_matches_plain(cuda, dtype, final_grad, b, s, h,
                                           p, g, n, chunk):
    """dx, ddt, dA, dB, dC against the plain backward on the same inputs,
    each relative to its largest value (f32: summation order and the
    segment differences' exponents; bf16: one rounding of the bf16
    outputs and of the scores before their products on the tensor
    cores)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    x, dt, a, bm, cm = _ssd_inputs(12, b, s, h, p, g, n)
    dy, ds = _randn(13, (b, s, h, p), (b, h, p, n))
    x, bm, cm, dy = (t.to(cuda, dtype) for t in (x, bm, cm, dy))
    dt, a = dt.to(cuda), a.to(cuda)
    ds = ds.to(cuda) if final_grad else None
    _, _, starts = ssd_scan(x, dt, a, bm, cm, chunk=chunk, states=True)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(x, dt, a, bm, cm, dy, ds, starts, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == before + 1
    want = ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, ds, chunk=chunk)
    # f32: ddt and dA carry the exponents' error (|cum| in the hundreds)
    # times A through the reverse cumsum of dcum
    tol = ({"ddt": 1e-3, "da": 1e-3} if dtype == torch.float32 else {})
    for name, u, v in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        bar = tol.get(name, 1e-4 if dtype == torch.float32 else 2e-2)
        assert _rel(u, v) <= bar, (name, _rel(u, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_of_ssd_and_gemm_are_bit_identical(cuda, dtype):
    """Two launches of each backward on the same inputs give the same
    bits: every sum has one order (no float atomics)."""
    from repro_torch.kernels.moe_gmm import expert_gemm_dw, expert_gemm_dx
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    x, dt, a, bm, cm = _ssd_inputs(14, 2, 512, 8, 64, 1, 128)
    dy, ds = _randn(15, (2, 512, 8, 64), (2, 8, 64, 128))
    x, bm, cm, dy = (t.to(cuda, dtype) for t in (x, bm, cm, dy))
    dt, a, ds = dt.to(cuda), a.to(cuda), ds.to(cuda)
    _, _, starts = ssd_scan(x, dt, a, bm, cm, chunk=256, states=True)
    one = ssd_scan_bwd(x, dt, a, bm, cm, dy, ds, starts, chunk=256)
    two = ssd_scan_bwd(x, dt, a, bm, cm, dy, ds, starts, chunk=256)
    xe, w, gy = (t.to(cuda, dtype) for t in
                 _randn(16, (4, 340, 256), (4, 256, 192), (4, 340, 192)))
    one += (expert_gemm_dx(gy, w, xe), expert_gemm_dw(xe, gy, w))
    two += (expert_gemm_dx(gy, w, xe), expert_gemm_dw(xe, gy, w))
    torch.cuda.synchronize()
    for u, v in zip(one, two):
        assert torch.equal(u, v)


# (E, C, d, f): a decode step's sizes (dropless C = batch), the routing
# prefix's capacity, ragged C, d and f, f not a multiple of 8 (the
# element-wise weight loads), and the full-width gate/up product.  Then
# the edges of the bf16 tensor-core tiling: C 1, 13, 300 and 200 (N 8, 16,
# three tiles of 128 and one of 256, the last two on two warpgroups), d
# and f not multiples of 64, and d or f not a multiple of 8 (no TMA: the
# CUDA-core kernel)
GEMM_CASES = [
    (4, 8, 64, 48), (3, 21, 64, 40), (2, 100, 96, 72), (2, 33, 50, 30),
    (60, 8, 2048, 1408),
    (3, 13, 200, 72), (2, 1, 136, 64), (2, 21, 72, 200), (2, 300, 200, 136),
    (3, 13, 200, 70), (2, 13, 60, 72), (2, 200, 136, 264),
    # bf16 reaches every wgmma width: C 30, 40, 60, 90, 150 take N 32, 48,
    # 64, 96 and 192 (the rest above take 8, 16, 24, 128 and 256)
    (2, 30, 136, 72), (2, 40, 200, 136), (2, 60, 136, 200), (2, 90, 200, 72),
    (2, 150, 136, 136),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GEMM_CASES)
def test_expert_gemm_kernel_matches_plain(cuda, dtype, e, c, d, f):
    """Against the f32 einsum on the same inputs, scaled so that outputs
    are about 1."""
    from repro_torch.kernels.moe_gmm import expert_gemm
    xe, w = _randn(10, (e, c, d), (e, d, f))
    xe, w = (xe * d ** -0.5).to(cuda, dtype), w.to(cuda, dtype)
    before = expert_gemm.launches
    out = expert_gemm(xe, w)
    torch.cuda.synchronize()
    assert expert_gemm.launches == before + 1
    plain = ref.expert_gemm_ref(xe, w)
    assert out.dtype == dtype and out.shape == (e, c, f)
    torch.testing.assert_close(out.float(), plain.float(), atol=TOL[dtype],
                               rtol=0)


# the backward tilings' edges (``moe_gmm.backward_plan``): C 1, 255-257
# (one dX block of two 128-column tiles or of two 136), 320, 340 and 360
# (2 x 160, 2 x 176, 2 x 184; dW panels of 320, 352 and 384 rows), d and f
# off dX's 128-row blocks, dW's 256-row panels and 128-column tiles and the
# 64-deep k-tiles, one expert
GEMM_BWD_EDGES = [(1, 1, 72, 136), (1, 255, 200, 136), (2, 256, 136, 72),
                  (2, 257, 264, 200), (1, 320, 392, 264), (2, 340, 72, 200),
                  (3, 340, 392, 136), (1, 360, 200, 392)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GEMM_CASES + [(2, 1360, 136, 72)]
                         + GEMM_BWD_EDGES)
def test_expert_gemm_bwd_kernels_match_plain(cuda, dtype, e, c, d, f):
    """dX = dY W^T and dW = X^T dY against the f32 einsums on the same
    inputs, scaled so that both are about N(0, 1/4): below 4, where one
    bf16 rounding is within TOL, and large against TOL."""
    from repro_torch.kernels.moe_gmm import expert_gemm_dw, expert_gemm_dx
    xe, w, dy = _randn(17, (e, c, d), (e, d, f), (e, c, f))
    xe, w = (xe * c ** -0.5).to(cuda, dtype), (w * f ** -0.5).to(cuda, dtype)
    dy = (dy * 0.5).to(cuda, dtype)
    before = expert_gemm_dx.launches, expert_gemm_dw.launches
    dx, dw = expert_gemm_dx(dy, w, xe), expert_gemm_dw(xe, dy, w)
    torch.cuda.synchronize()
    assert (expert_gemm_dx.launches, expert_gemm_dw.launches) == (
        before[0] + 1, before[1] + 1)
    pdx, pdw = ref.expert_gemm_bwd_ref(xe, w, dy)
    assert dx.dtype == dw.dtype == dtype
    assert dx.shape == xe.shape and dw.shape == w.shape
    assert min(float(pdx.float().std()), float(pdw.float().std())) > 0.2
    torch.testing.assert_close(dx.float(), pdx.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(dw.float(), pdw.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
def test_expert_gemm_bwd_refuses_a_plan_it_cannot_run(cuda):
    """The C entry points check `backward_plan`'s numbers: a dX tile wider
    than 184, groups that leave C uncovered, a dW panel short of C or a
    grid wider than its units return cudaErrorInvalidValue (1) and
    launch nothing; the plan itself runs."""
    import ctypes
    from repro_torch.kernels import moe_gmm as mg
    e, c, d, f = 2, 340, 136, 72
    xe, w, dy = (t.to(cuda, torch.bfloat16) for t in _randn(
        18, (e, c, d), (e, d, f), (e, c, f)))
    out = torch.zeros(e, c, d, device=cuda, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(xe.device).cuda_stream
    px, pw = mg.backward_plan(e, c, d, f)

    def dx_rc(n, groups, stages):
        return mg._lib("expert_gemm_dx")(
            dy.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f, 1, n,
            groups, stages, stream)

    def dw_rc(kp, grid, stages):
        dw = torch.zeros(e, d, f, device=cuda, dtype=torch.bfloat16)
        return mg._lib("expert_gemm_dw")(
            xe.data_ptr(), dy.data_ptr(), dw.data_ptr(), e, c, d, f, 1, kp,
            grid, stages, stream)

    assert dx_rc(px.n, px.groups, px.stages) == 0
    assert dw_rc(pw.kp, pw.grid, pw.stages) == 0
    torch.cuda.synchronize()
    out.zero_()
    for n, groups, stages in ((192, 1, 3), (88, 1, 3), (176, 1, 9),
                              (172, 1, 3)):
        assert dx_rc(n, groups, stages) == 1, (n, groups, stages)
    torch.cuda.synchronize()
    assert not out.any()
    for kp, grid, stages in ((320, 2, 3), (352, 3, 3), (352, 2, 9),
                             (416, 2, 2)):
        assert dw_rc(kp, grid, stages) == 1, (kp, grid, stages)


@pytest.mark.cuda
def test_bf16_tensor_core_kernels_raise_on_a_misaligned_base(cuda):
    """TMA loads from 16-byte aligned addresses only, and the bf16 paths
    (and router_assign's f32 one) have no other kernel: a contiguous view
    that starts one element into its storage raises instead of running
    elsewhere."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_dkv, flash_attention_dq, flash_attention_lse)
    from repro_torch.kernels.moe_gmm import expert_gemm
    q = torch.zeros(1 + 2 * 65 * 4 * 64, device=cuda,
                    dtype=torch.bfloat16)[1:].view(2, 65, 4, 64)
    k = torch.zeros(2, 65, 2, 64, device=cuda, dtype=torch.bfloat16)
    for fn in (flash_attention, flash_attention_lse):
        before = fn.launches
        with pytest.raises(RuntimeError, match="16-byte aligned"):
            fn(q, k, k)
        assert fn.launches == before
    lse = torch.zeros(2, 4, 65, device=cuda)
    for fn in (flash_attention_dkv, flash_attention_dq):
        before = fn.launches
        with pytest.raises(RuntimeError, match="16-byte aligned"):
            fn(q, k, k, q, lse, lse)
        assert fn.launches == before
    xe = torch.zeros(1 + 2 * 8 * 64, device=cuda,
                     dtype=torch.bfloat16)[1:].view(2, 8, 64)
    w = torch.zeros(2, 64, 48, device=cuda, dtype=torch.bfloat16)
    before = expert_gemm.launches
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        expert_gemm(xe, w)
    assert expert_gemm.launches == before
    from repro_torch.kernels.router_assign import router_assign
    for dtype in (torch.float32, torch.bfloat16):
        z = torch.zeros(1 + 64 * 64, device=cuda,
                        dtype=dtype)[1:].view(64, 64)
        before = router_assign.launches
        with pytest.raises(RuntimeError, match="16-byte aligned"):
            router_assign(z, torch.zeros(4, 64, device=cuda, dtype=dtype))
        assert router_assign.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_and_gemm_ops_backward_through_kernels(cuda, dtype):
    """A CUDA input that requires a gradient goes through SSDScan and
    ExpertGemm: the forward kernel and the backward kernels launch once
    each (nothing falls back), and the gradients match the plain path's
    (f32: summation order; bf16: one rounding of each output)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gmm import (expert_gemm, expert_gemm_dw,
                                             expert_gemm_dx)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    x, dt, a, bm, cm = (t.to(cuda) for t in
                        _ssd_inputs(11, 2, 128, 4, 32, 2, 64))
    x, bm, cm = (t.to(dtype) for t in (x, bm, cm))
    dy, ds = (t.to(cuda) for t in _randn(18, (2, 128, 4, 32), (2, 4, 32, 64)))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm)]
    before = ssd_scan.launches, ssd_scan_bwd.launches
    y, state = ops.ssd_scan(*leaves, chunk=64)
    ((y.float() * dy).sum() + (state * ds).sum()).backward()
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm)]
    py, pstate = ref.ssd_scan_ref(*plain, chunk=64)
    ((py.float() * dy).sum() + (pstate * ds).sum()).backward()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for u, v in zip(leaves, plain):
        assert u.grad.dtype == u.dtype and _rel(u.grad, v.grad) <= tol, \
            _rel(u.grad, v.grad)
    xe, w, gy = (t.to(cuda, dtype) for t in
                 _randn(19, (3, 40, 64), (3, 64, 48), (3, 40, 48)))
    xe.requires_grad_(True)
    w.requires_grad_(True)
    before = (expert_gemm.launches, expert_gemm_dx.launches,
              expert_gemm_dw.launches)
    (ops.expert_gemm(xe, w).float() * gy.float()).sum().backward()
    torch.cuda.synchronize()
    assert (expert_gemm.launches, expert_gemm_dx.launches,
            expert_gemm_dw.launches) == tuple(n + 1 for n in before)
    pdx, pdw = ref.expert_gemm_bwd_ref(xe.detach(), w.detach(), gy)
    assert _rel(xe.grad, pdx) <= tol and _rel(w.grad, pdw) <= tol
    # serving: no gradient, the forward kernels alone
    with torch.no_grad():
        before = ssd_scan_bwd.launches, expert_gemm_dx.launches
        ops.ssd_scan(*leaves, chunk=64)
        ops.expert_gemm(xe, w)
        assert (ssd_scan_bwd.launches, expert_gemm_dx.launches) == before


# the last three families at their published heads (H, KH, D; d_model =
# H D), as tests/test_torch_families_heads.py builds them; their smoke
# configs are at head_dim 64
FAMILY_HEADS = {"gemma-2b": (8, 1, 256), "nemotron-4-340b": (12, 1, 192),
                "qwen3-moe-235b-a22b": (16, 1, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2-moe-a2.7b",
                                  *FAMILY_HEADS])
def test_new_families_train_through_their_kernels(cuda, arch):
    """One loss gradient of the smoke config through the kernels
    (attn_impl="pallas") against the plain path's, leaf by leaf, in f32:
    summation order only.  The last three families at their published
    heads launch the LSE forward, dK/dV and dQ once a block (dK/dV as
    many times as ``dkv_launches`` says)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention_bwd import (
        dkv_launches, flash_attention_dkv, flash_attention_dq,
        flash_attention_lse)
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves
    cfg = get_smoke_config(arch).replace(attn_impl="pallas")
    if arch in FAMILY_HEADS:
        h, kh, d = FAMILY_HEADS[arch]
        cfg = cfg.replace(num_heads=h, num_kv_heads=kh, head_dim=d,
                          d_model=h * d)
    params = api.init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(2))
    grads = {}
    kernels = (flash_attention_lse, flash_attention_dkv, flash_attention_dq)
    for impl in ("pallas", "full"):
        before = [f.launches for f in kernels]
        loss, _, g = value_and_grad(params, cfg.replace(attn_impl=impl),
                                    {"tokens": toks})
        grads[impl] = (float(loss), tree_leaves(g))
        if impl == "pallas" and arch in FAMILY_HEADS:
            torch.cuda.synchronize()
            n = cfg.num_layers
            assert [f.launches - b for f, b in zip(kernels, before)] == \
                [n, n * dkv_launches(getattr(torch, cfg.dtype),
                                     cfg.head_dim), n]
    assert abs(grads["pallas"][0] - grads["full"][0]) <= 1e-4
    for u, v in zip(grads["pallas"][1], grads["full"][1]):
        err = float((u - v).norm() / v.norm().clamp_min(1e-30))
        assert err <= 1e-3, err


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2-moe-a2.7b"])
def test_new_families_go_through_their_kernels(cuda, arch):
    """The wiring at smoke size: the pallas forward launches ssd_scan
    once per Mamba block and expert_gemm three times per MoE block, and
    prefill + decode through the kernels match the plain path (f32:
    summation order only)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.moe_gmm import expert_gemm
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import api
    cfg = get_smoke_config(arch).replace(attn_impl="pallas")
    plain = cfg.replace(attn_impl="full")
    params = api.init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 70), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    counts = ssd_scan.launches, expert_gemm.launches
    with torch.inference_mode():
        api.forward_logits(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        mamba = arch.startswith("mamba")
        assert (ssd_scan.launches - counts[0],
                expert_gemm.launches - counts[1]) == (
            (cfg.num_layers, 0) if mamba else (0, 3 * cfg.num_layers))
        lk, ck = api.prefill(params, cfg, {"tokens": toks[:, :60]}, 72)
        lp, cp = api.prefill(params, plain, {"tokens": toks[:, :60]}, 72)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)
        for t in range(60, 70):
            tok = toks[:, t:t + 1]
            lk, ck = api.serve_step(params, cfg, {"tokens": tok}, ck, t)
            lp, cp = api.serve_step(params, plain, {"tokens": tok}, cp, t)
            torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)


def _serve_trace_cuda(cuda, cfg, paths, graph: bool, trace_seed: int = 5):
    """The continuous engine over ``paths`` on the simulated clock (the
    same admissions and ticks in every run), warmed up (and the dense
    tick captured where ``graph``) -> (engine, {rid: tokens})."""
    from repro_torch.serving import (ContinuousBatchingEngine, EngineOptions,
                                     poisson_trace, prefix_hash_router)
    eng = ContinuousBatchingEngine(cfg, paths, options=EngineOptions(
        cache_len=48, slots_per_path=4, cuda_graph=graph,
        route_fn=prefix_hash_router(len(paths))))
    eng.warmup()
    trace = poisson_trace(24, rate=300.0, prompt_lens=(8, 12, 20),
                          max_new=10, vocab_size=cfg.vocab_size,
                          seed=trace_seed)
    fins = eng.serve_trace(trace)
    return eng, {f.rid: f.tokens for f in fins}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_tick_matches_eager_tick(cuda, dtype):
    """The dense stacked tick replayed from its CUDA graph gives the eager
    tick's greedy tokens and the same cache bits, on a small arena (4
    paths x 4 slots) through flash-decode; the graph run replays every
    dense tick and launches flash-decode only in sparse ticks."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves
    cfg = get_smoke_config("dipaco-150m").replace(attn_impl="pallas",
                                                  dtype=dtype)
    paths = [api.init_model(cfg, seed=p, device=cuda) for p in range(4)]
    eager, want = _serve_trace_cuda(cuda, cfg, paths, graph=False)
    assert eager._graph is None
    before = flash_decode.launches
    graph, got = _serve_trace_cuda(cuda, cfg, paths, graph=True)
    stats = graph.decode_stats
    assert graph._graph is not None
    assert stats["graph_replays"] == stats["dense"] > 0
    # warm-up (a dense and an island step), the capture's warm-up and the
    # capture call the wrapper once a block each; then only the sparse
    # ticks' islands launch from the host
    assert flash_decode.launches - before == cfg.num_layers * (
        4 + stats["sparse_islands"])
    assert sorted(got) == sorted(want) == list(range(24))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    for a, b in zip(tree_leaves(eager._stacked_arenas.cache),
                    tree_leaves(graph._stacked_arenas.cache)):
        assert torch.equal(a, b)
    # a graph engine that was never warmed up refuses to tick eagerly
    from repro_torch.serving import (ContinuousBatchingEngine, EngineOptions,
                                     prefix_hash_router)
    cold = ContinuousBatchingEngine(cfg, paths, options=EngineOptions(
        cache_len=48, slots_per_path=4, cuda_graph=True,
        route_fn=prefix_hash_router(len(paths))))
    with pytest.raises(RuntimeError, match="warmup"):
        cold.step()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("dipaco-150m", {"dtype": "float32"}),
    ("dipaco-150m", {"dtype": "bfloat16"}),
    ("dipaco-150m", {"dtype": "float32", "kv_quant": True}),
    ("mamba2-1.3b", {"dtype": "float32"}),
    ("qwen2-moe-a2.7b", {"dtype": "float32"})])
def test_decode_step_paths_matches_per_path_decode(cuda, arch, kw):
    """``decode_step_paths`` (one flash-decode launch a layer over the P x
    S rows) against P masked ``decode_step`` calls on views of the stack:
    logits and written cache rows within the dtype's tolerance (the
    products are batched over P; flash-decode splits its rows
    differently), masked rows bit for bit unchanged."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.models import api, lm
    from repro_torch.models.params import tree_leaves, tree_map
    cfg = get_smoke_config(arch).replace(attn_impl="pallas", **kw)
    n_paths, slots, cache_len = 3, 4, 40
    paths = [api.init_model(cfg, seed=p, device=cuda)
             for p in range(n_paths)]
    stacked = lm.stack_paths(paths)
    g = torch.Generator(cuda).manual_seed(3)
    one = api.init_serve_cache(cfg, slots, cache_len, device=cuda)
    caches = tree_map(lambda a: (torch.randn(
        (a.shape[0], n_paths, *a.shape[1:]), generator=g, device=cuda)
        * (40 if a.dtype == torch.int8 else 1)).to(a.dtype), one)
    looped = tree_map(torch.clone, caches)
    before = tree_map(torch.clone, caches)
    tok = torch.randint(0, cfg.vocab_size, (n_paths, slots, 1), generator=g,
                        device=cuda)
    idx = torch.randint(0, 2 * cache_len, (n_paths, slots), generator=g,
                        device=cuda).int()
    mask = torch.tensor([[True, False, True, True], [False] * 4,
                         [True] * 4], device=cuda)
    tol = TOL[torch.float32 if kw["dtype"] == "float32" else torch.bfloat16]
    attn_blocks = sum(s.mixer == "attn" for s in cfg.pattern) * \
        cfg.pattern_repeats
    with torch.inference_mode():
        n0 = flash_decode.launches
        logits, _ = lm.decode_step_paths(stacked, cfg, tok, caches, idx, mask)
        assert flash_decode.launches - n0 == attn_blocks
        for p in range(n_paths):
            lp, _ = api.serve_step(lm.path_view(stacked, p), cfg,
                                   {"tokens": tok[p]},
                                   tree_map(lambda a, p=p: a[:, p], looped),
                                   idx[p], mask=mask[p])
            rows = mask[p]
            torch.testing.assert_close(logits[p][rows].float(),
                                       lp[rows].float(), atol=tol * 10,
                                       rtol=0)
    torch.cuda.synchronize()
    for a, b, old in zip(tree_leaves(caches), tree_leaves(looped),
                         tree_leaves(before)):
        assert torch.equal(a[:, ~mask], old[:, ~mask])
        assert torch.equal(b[:, ~mask], old[:, ~mask])
        # int8: a value on a rounding tie may quantize one step apart
        torch.testing.assert_close(
            a.float(), b.float(), rtol=0,
            atol=1.0 if a.dtype == torch.int8 else tol * 10)
