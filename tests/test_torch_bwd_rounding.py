"""The arithmetic of the bf16 flash-attention backward on the tensor cores
(``csrc/flash_attention_bwd.cu``), modelled on the CPU: P and dS are
rounded to bf16 before their products, sums are f32, the gradients come
out in bf16.  The model stays inside the bf16 gradient tolerance that the
card tests hold the kernels to (2e-2 of the largest gradient), where the
TPU kernel multiplies f32 P and dS."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

GRAD_TOL_BF16 = 2e-2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _tensor_core_bwd(q, k, v, o, lse, do, causal, window):
    """ref.flash_attention_bwd_ref with the kernels' roundings."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    p = torch.exp(ref._masked_scores(q, k, causal, window)
                  - lse.reshape(b, kh, g, s)[..., None])     # (B,KH,G,S,S)
    dog = do.reshape(b, s, kh, g, d)
    delta = (dog * o.reshape(b, s, kh, g, d)).sum(-1)         # (B,S,KH,G)
    dv = torch.einsum("bkgqs,bqkgd->bskd", _bf16(p), dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v)
    ds = _bf16(p * (dp - delta.permute(0, 2, 3, 1)[..., None])
               / math.sqrt(d))
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.reshape(b, s, kh, g, d))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k).reshape(b, s, h, d)
    return tuple(_bf16(x) for x in (dq, dk, dv))


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (2, 80, 2, 2, 32, True, None),
    (2, 65, 8, 2, 32, False, None),
    (1, 333, 8, 2, 64, True, 100),
    (2, 65, 4, 2, 128, True, 7),
    (2, 128, 4, 4, 64, True, None),
    (2, 80, 8, 1, 256, True, None),
    (1, 96, 12, 1, 192, True, 40),
])
def test_bf16_p_and_ds_stay_inside_the_gradient_tolerance(b, s, h, kh, d,
                                                          causal, window):
    rng = np.random.default_rng(3)
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)))
        for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d),
                      (b, s, h, d)))
    o, lse = ref.fwd_with_lse_ref(q, k, v, causal=causal, window=window)
    exact = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    got = _tensor_core_bwd(q, k, v, _bf16(o), lse, do, causal, window)
    for name, a, e in zip(("dq", "dk", "dv"), got, exact):
        err = float((a - e).abs().max() / e.abs().max())
        assert 0 < err <= GRAD_TOL_BF16, (name, err)
