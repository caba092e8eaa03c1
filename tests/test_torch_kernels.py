"""The plain versions of the port's attention kernels
(``repro_torch.kernels.ref``, reached through ``ops`` as the CPU path
does) against the JAX Pallas kernels in interpret mode, on the same
numpy-seeded inputs, to 1e-5 in f32.  The CUDA kernels themselves are
held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as jflash_decode
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ops, ref


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _quant(x):
    scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
    qx = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return qx, scale


T_ = torch.from_numpy

# the cases of tests/test_decode_kernel.py::test_flash_decode_vs_ref
DECODE_CASES = [
    (2, 4, 4, 32, 32, [5, 20], None, 8),        # MHA, mid-cache
    (3, 8, 2, 64, 64, [0, 31, 63], None, 16),   # GQA g=4, full cache
    (2, 4, 1, 32, 48, [10, 40], None, 16),      # MQA
    (2, 4, 2, 32, 32, [40, 70], None, 8),       # ring wrap (ci > T)
    (2, 4, 2, 32, 32, [12, 45], 8, 8),          # sliding window + wrap
    (1, 2, 2, 16, 24, [3], 16, 128),            # block_k > T (shrinks)
    (2, 4, 2, 32, 40, [7, 90], 12, 8),          # non-pow2 T, deep wrap
    # the published query groups and head dims of the last three families
    (2, 8, 1, 256, 16, [3, 20], None, 8),       # gemma-2b: G 8, D 256
    (2, 24, 2, 192, 24, [23, 30], 8, 8),        # nemotron: G 12, D 192
    (2, 32, 2, 128, 24, [5, 40], None, 8),      # qwen3-moe: G 16, D 128
]
# (B, H, KH, D, T, cache_index): those three with an int8 cache
WIDE_DECODE_CASES = [(2, 8, 1, 256, 16, [3, 20]),
                     (2, 24, 2, 192, 24, [23, 30]),
                     (2, 32, 2, 128, 24, [5, 40])]


@pytest.mark.parametrize("b,h,kh,d,T,ci,window,block_k", DECODE_CASES)
def test_flash_decode_plain_matches_pallas(b, h, kh, d, T, ci, window,
                                           block_k):
    q, kc, vc = _randn(0, (b, h, d), (b, T, kh, d), (b, T, kh, d))
    ci = np.asarray(ci, np.int32)
    expect = jflash_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                           jnp.asarray(ci), window=window, block_k=block_k,
                           interpret=True)
    out = ops.decode_attention(T_(q), T_(kc), T_(vc), T_(ci), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_flash_decode_plain_int8_matches_pallas(window, qdtype):
    b, h, kh, d, T = 2, 4, 2, 32, 32
    q, kc, vc = _randn(2, (b, h, d), (b, T, kh, d), (b, T, kh, d))
    (kq, ks), (vq, vs) = _quant(kc), _quant(vc)
    ci = np.asarray([6, 50], np.int32)
    jq = jnp.asarray(q).astype(qdtype)
    expect = jflash_decode(jq, jnp.asarray(kq), jnp.asarray(vq),
                           jnp.asarray(ci), window=window,
                           k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                           block_k=8, interpret=True)
    tq = T_(q).to(getattr(torch, qdtype))
    out = ops.decode_attention(tq, T_(kq), T_(vq), T_(ci), window=window,
                               k_scale=T_(ks), v_scale=T_(vs))
    assert out.dtype == tq.dtype
    tol = 1e-5 if qdtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,kh,d,T,ci", WIDE_DECODE_CASES)
def test_flash_decode_plain_int8_wide_heads_match_pallas(b, h, kh, d, T,
                                                         ci):
    q, kc, vc = _randn(6, (b, h, d), (b, T, kh, d), (b, T, kh, d))
    (kq, ks), (vq, vs) = _quant(kc), _quant(vc)
    ci = np.asarray(ci, np.int32)
    expect = jflash_decode(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                           jnp.asarray(ci), k_scale=jnp.asarray(ks),
                           v_scale=jnp.asarray(vs), block_k=8,
                           interpret=True)
    out = ops.decode_attention(T_(q), T_(kq), T_(vq), T_(ci),
                               k_scale=T_(ks), v_scale=T_(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("group,blocks", [
    (1, 1), (2, 1), (3, 2), (8, 4), (12, 6), (16, 8), (96, 48)])
def test_flash_decode_head_groups(group, blocks):
    """The blocks that share a KV head's query heads: MAX_GROUP heads a
    block, the last holding fewer when the group is odd, none empty."""
    from repro_torch.kernels.decode_attention import MAX_GROUP, head_groups
    assert head_groups(group) == blocks
    assert (blocks - 1) * MAX_GROUP < group <= blocks * MAX_GROUP


def test_flash_decode_plain_bf16_matches_reference_ref():
    q, kc, vc = _randn(1, (2, 8, 64), (2, 32, 4, 64), (2, 32, 4, 64))
    ci = np.asarray([9, 27], np.int32)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, kc, vc)]
    expect = jref.flash_decode_ref(*jb, jnp.asarray(ci))
    tb = [T_(x).bfloat16() for x in (q, kc, vc)]
    out = ref.flash_decode_ref(*tb, T_(ci))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(expect, np.float32),
                               atol=2e-2, rtol=2e-2)


# (B, S, H, KH, D, window, block): MHA, GQA, MQA, windows, ragged S
ATTN_CASES = [
    (2, 64, 4, 4, 32, None, 16),
    (2, 64, 8, 2, 32, None, 16),
    (1, 48, 4, 1, 16, None, 16),
    (2, 64, 4, 2, 32, 16, 16),
    (2, 50, 4, 2, 32, None, 16),     # ragged: the Pallas side pads
    (1, 77, 4, 4, 32, 24, 32),       # ragged + window
    (2, 40, 8, 1, 256, None, 16),    # gemma-2b's heads, ragged
    (2, 48, 24, 2, 192, 16, 16),     # nemotron's (G 12), window
]


@pytest.mark.parametrize("b,s,h,kh,d,window,block", ATTN_CASES)
def test_flash_attention_plain_matches_pallas(b, s, h, kh, d, window, block):
    q, k, v = _randn(3, (b, s, h, d), (b, s, kh, d), (b, s, kh, d))
    pad = (-s) % block       # the Pallas kernel needs whole blocks, as
    padded = [np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))   # layers.py
              for x in (q, k, v)]                              # pads them
    expect = jflash(*map(jnp.asarray, padded), causal=True, window=window,
                    block_q=block, block_k=block, interpret=True)[:, :s]
    out = ops.flash_attention(T_(q), T_(k), T_(v), causal=True,
                              window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8), (False, 8)])
def test_flash_attention_plain_matches_reference_ref(causal, window):
    q, k, v = _randn(4, (2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32))
    expect = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, window=window)
    out = ref.flash_attention_ref(T_(q), T_(k), T_(v), causal=causal,
                                  window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               atol=1e-5, rtol=1e-5)
