"""The arithmetic of the f32 k-means assignment on the tensor cores
(``csrc/router_assign.cu``, 3xTF32), modelled on the CPU: each input
splits into hi = tf32(x) and lo = tf32(x - hi) (a 10-bit mantissa,
rounded to nearest with ties away from zero, as ``cvt.rna.tf32.f32``);
z.c is lo_z.hi_c + hi_z.lo_c + hi_z.hi_c, each k8 step's products exact
(f64) and added to an f32 accumulator; ||z||^2 and ||c||^2 are f32 sums.

The model holds the bar that the card tests hold the kernel to against
the plain f32 version: no argmin flip where the two best distances are
more than 1e-5 of the distance scale apart, flips in at most 1e-3 of the
rows, and min d2 within 1e-5 of the scale.  One TF32 product alone
(hi_z.hi_c, about 3 digits) breaks that bar, so the card tests would
catch a kernel that silently dropped the small products."""
import numpy as np
import pytest
import torch

from repro_torch.core.routing.kmeans import squared_distances
from repro_torch.kernels import ref

TOL_REL = 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to a 10-bit mantissa: add half of the 13 dropped bits to
    the magnitude (ties away from zero), then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tensor_core_assign(z, c, products: int = 3):
    """-> (assign, min d2) as the kernel computes them in f32."""
    zh, ch = _tf32(z), _tf32(c)
    zl, cl = _tf32(z - zh), _tf32(c - ch)
    acc = torch.zeros(z.shape[0], c.shape[0], dtype=torch.float32)
    for k0 in range(0, z.shape[1], 8):
        s = slice(k0, k0 + 8)
        step = zh[:, s].double() @ ch[:, s].double().T
        if products == 3:
            step += (zl[:, s].double() @ ch[:, s].double().T
                     + zh[:, s].double() @ cl[:, s].double().T)
        acc = (acc.double() + step).float()
    d2 = ((z * z).sum(-1, keepdim=True) - 2 * acc) + (c * c).sum(-1)[None]
    mind2, assign = d2.min(dim=-1)
    return assign.to(torch.int32), mind2


def _bar(z, c, a, d2):
    """-> (wrong flips, flips, min d2 error / scale) against the plain
    f32 version."""
    pa, pd2 = ref.router_assign_ref(z, c)
    full = squared_distances(z, c)
    scale = float(full.abs().max())
    top2 = torch.topk(-full, min(2, c.shape[0]), dim=-1).values
    gap = (top2[:, 0] - top2[:, -1]).abs()
    differ = a != pa
    wrong = int((differ & (gap > TOL_REL * scale)).sum())
    return wrong, int(differ.sum()), float((d2 - pd2).abs().max()) / scale


def _inputs(n, d, k, magnitude, seed=8):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        (rng.standard_normal(shape) * magnitude).astype(np.float32))
        for shape in ((n, d), (k, d)))


@pytest.mark.parametrize("magnitude", [1.0, 1e3])
@pytest.mark.parametrize("n,d,k", [(513, 32, 8), (1000, 64, 16),
                                   (300, 96, 70), (2048, 896, 4),
                                   (1000, 128, 257), (333, 36, 24),
                                   (4096, 896, 256)])
def test_three_tf32_products_hold_the_f32_bar(n, d, k, magnitude):
    z, c = _inputs(n, d, k, magnitude)
    wrong, flips, err = _bar(z, c, *_tensor_core_assign(z, c))
    assert wrong == 0 and flips <= 1e-3 * n, (wrong, flips)
    assert err <= TOL_REL, err


@pytest.mark.parametrize("magnitude", [1.0, 1e3])
def test_one_tf32_product_breaks_the_bar(magnitude):
    z, c = _inputs(4096, 896, 256, magnitude)
    wrong, flips, err = _bar(z, c, *_tensor_core_assign(z, c, products=1))
    assert wrong > 0 or flips > 1e-3 * 4096 or err > TOL_REL, \
        (wrong, flips, err)
    assert err > TOL_REL, err
