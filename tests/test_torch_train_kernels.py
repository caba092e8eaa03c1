"""The plain versions of the training slice's kernels
(``repro_torch.kernels.ref``, reached through ``ops`` as the CPU path
does) against the JAX Pallas kernels in interpret mode, on the same
numpy-seeded inputs: the forward that writes the LSE rows, the dK/dV and
dQ backward kernels, the ``FlashAttention`` autograd Function, and the
k-means assignment.  The CUDA kernels themselves are held against these
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention_bwd import _fwd_with_lse
from repro.kernels.flash_attention_bwd import \
    flash_attention_bwd as jflash_bwd
from repro.models.layers import full_attention as jfull_attention
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import api

T_ = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this module: under pytest-xdist each worker
    would otherwise start a thread pool as wide as the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the cases of tests/test_kernels.py::test_flash_attention_backward
BWD_CASES = [
    (128, 4, 2, 32, True, None),
    (96, 2, 1, 64, True, 24),
    (64, 4, 4, 32, False, None),
    (80, 2, 2, 32, True, None),     # ragged tail: s not a block multiple
    (64, 4, 2, 32, False, 16),      # non-causal sliding window + GQA
    (40, 8, 1, 256, True, None),    # gemma-2b's heads, ragged
    (48, 24, 2, 192, True, 16),     # nemotron-4-340b's G 12, windowed
]
# f32: the same f32 arithmetic in another summation order
TOL = 2e-5


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _inputs(s, h, kh, d, seed=1):
    return _randn(seed, (2, s, h, d), (2, s, kh, d), (2, s, kh, d),
                  (2, s, h, d))


def _bf16(x):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    t = T_(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


@pytest.mark.parametrize("s,h,kh,d,causal,window", BWD_CASES)
def test_fwd_with_lse_plain_matches_pallas(s, h, kh, d, causal, window):
    q, k, v, _ = _inputs(s, h, kh, d)
    eo, e_lse = _fwd_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, block_q=32,
                              block_k=32, interpret=True)
    o, lse = ops.fwd_with_lse(T_(q), T_(k), T_(v), causal=causal,
                              window=window)
    assert o.shape == q.shape and lse.shape == (2, h, s)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(eo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(e_lse), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("s,h,kh,d,causal,window", BWD_CASES)
def test_flash_attention_bwd_plain_matches_pallas(s, h, kh, d, causal,
                                                  window):
    q, k, v, do = _inputs(s, h, kh, d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    eo, e_lse = _fwd_with_lse(jq, jk, jv, causal=causal, window=window,
                              block_q=32, block_k=32, interpret=True)
    expect = jflash_bwd(jq, jk, jv, eo, e_lse, jdo, causal=causal,
                        window=window, block_q=32, block_k=32,
                        interpret=True)
    got = ops.flash_attention_bwd(T_(q), T_(k), T_(v), T_(np.array(eo)),
                                  T_(np.array(e_lse)), T_(do),
                                  causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_training_attention_plain_matches_pallas_bf16():
    """bf16 inputs: both sides compute in f32 from the same bf16 values;
    the outputs differ by at most one bf16 rounding (2^-8 relative, so
    2e-2 absolute below 4), lse (f32) to 1e-4."""
    s, h, kh, d = 80, 4, 2, 32
    q, k, v, do = _inputs(s, h, kh, d, seed=3)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_bf16(x) for x in
                                                (q, k, v, do))
    eo, e_lse = _fwd_with_lse(jq, jk, jv, causal=True, window=None,
                              block_q=32, block_k=32, interpret=True)
    o, lse = ops.fwd_with_lse(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(eo, np.float32), atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(e_lse), atol=1e-4,
                               rtol=1e-4)
    expect = jflash_bwd(jq, jk, jv, eo, e_lse, jdo, causal=True, window=None,
                        block_q=32, block_k=32, interpret=True)
    got = ops.flash_attention_bwd(tq, tk, tv, _bf16(np.asarray(
        eo, np.float32))[1], T_(np.array(e_lse)), tdo, causal=True)
    for a, b in zip(got, expect):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=2e-2)


@pytest.mark.parametrize("s,h,kh,d,causal,window", BWD_CASES)
def test_flash_attention_function_grads_match_jax(s, h, kh, d, causal,
                                                  window):
    """FlashAttention through torch.autograd.grad against jax.grad of the
    reference's plain full attention."""
    q, k, v, do = _inputs(s, h, kh, d)

    def f_ref(q_, k_, v_):
        return jnp.sum(jfull_attention(q_, k_, v_, causal=causal,
                                       window=window) * jnp.asarray(do))

    expect = jax.grad(f_ref, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (T_(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention_trainable(tq, tk, tv, causal=causal,
                                        window=window)
    got = torch.autograd.grad((out * T_(do)).sum(), (tq, tk, tv))
    for a, b in zip(got, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL)


def test_pallas_model_grads_reach_attention_weights():
    """The repair on the CPU: with attn_impl="pallas" the loss's gradient
    goes through FlashAttention and equals the plain path's, for wq, wk,
    wv and every other leaf."""
    cfg = get_smoke_config("dipaco-150m").replace(route_prefix_len=8)
    params = api.init_model(cfg, seed=0, device="cpu")
    toks = T_(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48)))
    grads = {}
    for impl in ("pallas", "full"):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params["blocks"]["pos0"]["mixer"].items()}
        p = {**params, "blocks": {"pos0": {**params["blocks"]["pos0"],
                                           "mixer": leaves}}}
        loss, _ = api.forward_loss(p, cfg.replace(attn_impl=impl),
                                   {"tokens": toks})
        grads[impl] = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    for name in ("wq", "wk", "wv", "wo"):
        a, b = grads["pallas"][name], grads["full"][name]
        assert a.abs().max() > 0, name
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("n,d,k,dtype", [
    (513, 32, 8, "float32"),     # ragged N
    (1000, 64, 16, "float32"),
    (256, 128, 4, "bfloat16"),   # the slice's own K = 4
    (300, 96, 70, "float32"),    # K over one centroid tile of the kernel
])
def test_router_assign_plain_matches_pallas(n, d, k, dtype):
    """Same argmin except where the two best distances lie within f32
    rounding of each other (the summation orders differ); min d2 to
    1e-5 relative to the feature scale."""
    z, c = _randn(4, (n, d), (k, d))
    if dtype == "bfloat16":
        (jz, tz), (jc, tc) = _bf16(z), _bf16(c)
    else:
        jz, jc, tz, tc = jnp.asarray(z), jnp.asarray(c), T_(z), T_(c)
    ea, ed2 = jops.router_assign(jz, jc, block_n=128, interpret=True)
    a, d2 = ops.router_assign(tz, tc)
    assert a.dtype == torch.int32 and d2.dtype == torch.float32
    full = ((tz.float()[:, None, :] - tc.float()[None]) ** 2).sum(-1)
    top2 = torch.topk(-full, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).abs()
    scale = float(full.abs().max())
    differ = a.numpy() != np.asarray(ea)
    assert (gap[torch.from_numpy(differ)] <= 1e-5 * scale).all()
    assert differ.mean() <= 1e-3
    np.testing.assert_allclose(d2.numpy(), np.asarray(ed2),
                               atol=1e-5 * scale, rtol=1e-5)


def test_router_assign_ties_go_to_first_index():
    z = torch.zeros(5, 8)
    c = torch.zeros(3, 8)
    a, d2 = ops.router_assign(z, c)
    assert a.tolist() == [0] * 5 and d2.tolist() == [0.0] * 5
