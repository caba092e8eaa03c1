"""The backward of the SSD scan and of the expert GEMM on the CPU, in f32
at small sizes: the plain backwards (``ref.ssd_scan_bwd_ref``,
``ref.expert_gemm_bwd_ref``) against ``torch.autograd`` through the plain
forwards and against ``jax.grad`` of the reference's ``ssd_chunked`` and
expert einsum; the ``SSDScan`` and ``ExpertGemm`` Functions, which ``ops``
takes for inputs that require a gradient (on the CPU they join the plain
forward and the plain backward), against autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref

T_ = torch.from_numpy
NAMES = ("dx", "ddt", "da", "dB", "dC")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this module: under pytest-xdist each worker
    would otherwise start a thread pool as wide as the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(seed, b, s, h, p, g, n, pad=0):
    """x, dt (softplus of a shifted normal, as the model's), A (-1..-h / 2),
    grouped B, C, the output gradient dy and the final state's gradient,
    all f32; with ``pad`` the last tokens are zero (dt = 0), as
    ``apply_mamba`` pads a ragged length to its chunk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0)).astype(
        np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32) / 2
    bm = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    if pad:
        for t in (x, dt, bm, cm):
            t[:, s - pad:] = 0
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, dy, ds


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# (B, S, H, P, G, N, chunk, padded tail, final-state gradient): one chunk,
# several chunks, G = 1 and G = H, a chunk that is not a power of two, a
# padded tail
SSD_BWD_CASES = [
    (2, 32, 4, 16, 1, 16, 32, 0, True),
    (2, 96, 4, 16, 2, 8, 32, 0, True),
    (1, 60, 6, 8, 3, 16, 12, 5, False),
    (2, 64, 4, 8, 4, 8, 16, 0, False),
    (2, 128, 2, 32, 1, 32, 64, 20, True),
    (1, 48, 4, 8, 4, 16, 16, 0, True),
]
# relative to each gradient's largest value: f32 sums in another order;
# dA sums B S terms, so it keeps 1e-5 against autograd
AUTOGRAD_TOL = dict(zip(NAMES, (1e-6, 1e-6, 1e-5, 1e-6, 1e-6)))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,pad,final", SSD_BWD_CASES)
def test_ssd_scan_bwd_ref_matches_autograd(b, s, h, p, g, n, chunk, pad,
                                           final):
    x, dt, a, bm, cm, dy, ds = _ssd_inputs(0, b, s, h, p, g, n, pad)
    leaves = [T_(t).requires_grad_(True) for t in (x, dt, a, bm, cm)]
    y, state = ref.ssd_scan_ref(*leaves, chunk=chunk)
    loss = (y * T_(dy)).sum() + ((state * T_(ds)).sum() if final else 0)
    want = torch.autograd.grad(loss, leaves)
    got = ref.ssd_scan_bwd_ref(*map(T_, (x, dt, a, bm, cm)), T_(dy),
                               T_(ds) if final else None, chunk=chunk)
    for name, u, v, t in zip(NAMES, got, want, (x, dt, a, bm, cm)):
        assert u.dtype == torch.float32 and u.shape == t.shape, name
        assert _rel(u, v) <= AUTOGRAD_TOL[name], (name, _rel(u, v))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,pad,final", SSD_BWD_CASES)
def test_ssd_scan_bwd_ref_matches_jax_grad_of_ssd_chunked(b, s, h, p, g, n,
                                                          chunk, pad, final):
    x, dt, a, bm, cm, dy, ds = _ssd_inputs(1, b, s, h, p, g, n, pad)

    def loss(*args):
        y, state = jssm.ssd_chunked(*args, chunk)
        return jnp.sum(y * dy) + (jnp.sum(state * ds) if final else 0.0)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, dt, a, bm, cm)))
    got = ref.ssd_scan_bwd_ref(*map(T_, (x, dt, a, bm, cm)), T_(dy),
                               T_(ds) if final else None, chunk=chunk)
    for name, u, v in zip(NAMES, got, want):
        assert _rel(u.numpy(), v) <= 1e-5, (name, _rel(u.numpy(), v))


@pytest.mark.parametrize("e,c,d,f", [(4, 8, 32, 48), (3, 21, 64, 40),
                                     (2, 33, 50, 30),
                                     # the backward tilings' edges at
                                     # narrow d and f
                                     (2, 255, 24, 40), (2, 257, 40, 24),
                                     (1, 340, 32, 16)])
def test_expert_gemm_bwd_ref_matches_jax_grad_of_the_einsum(e, c, d, f):
    rng = np.random.default_rng(2)
    xe, w = (rng.standard_normal(s).astype(np.float32)
             for s in ((e, c, d), (e, d, f)))
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    want = jax.grad(lambda u, v: jnp.sum(
        jnp.einsum("ecd,edf->ecf", u, v) * dy), argnums=(0, 1))(
        jnp.asarray(xe), jnp.asarray(w))
    got = ref.expert_gemm_bwd_ref(T_(xe), T_(w), T_(dy))
    for u, v in zip(got, want):
        assert u.dtype == torch.float32
        assert _rel(u.numpy(), v) <= 1e-5


@pytest.mark.parametrize("use", ["both", "y", "state"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,pad,final", SSD_BWD_CASES[:4])
def test_ssd_scan_function_matches_autograd_on_cpu(b, s, h, p, g, n, chunk,
                                                   pad, final, use):
    """ops.ssd_scan on inputs that require a gradient goes through
    SSDScan (plain forward, plain backward), whichever of its outputs the
    loss reads."""
    x, dt, a, bm, cm, dy, ds = _ssd_inputs(3, b, s, h, p, g, n, pad)
    grads = {}
    for how in ("function", "autograd"):
        leaves = [T_(t).requires_grad_(True) for t in (x, dt, a, bm, cm)]
        if how == "function":
            y, state = ops.ssd_scan(*leaves, chunk=chunk)
            assert type(y.grad_fn).__name__ == "SSDScanBackward"
        else:
            y, state = ref.ssd_scan_ref(*leaves, chunk=chunk)
        loss = ((y * T_(dy)).sum() if use != "state" else 0) \
            + ((state * T_(ds)).sum() if use != "y" else 0)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        # the final state does not read C: autograd gives it no gradient
        grads[how] = [torch.zeros_like(t) if d is None else d
                      for t, d in zip(leaves, got)]
    for name, u, v in zip(NAMES, grads["function"], grads["autograd"]):
        if name == "dC" and use == "state":
            assert float(u.abs().max()) == 0
            continue
        assert _rel(u, v) <= AUTOGRAD_TOL[name], (name, _rel(u, v))


def test_ssd_scan_function_takes_only_the_inputs_that_need_it():
    """A gradient for x alone (dt, A, B, C fixed) and no gradient at all
    (serving: the plain forward, no Function)."""
    x, dt, a, bm, cm, dy, _ = _ssd_inputs(4, 1, 40, 2, 8, 1, 8)
    xt = T_(x).requires_grad_(True)
    y, _ = ops.ssd_scan(xt, *map(T_, (dt, a, bm, cm)), chunk=8)
    (gx,) = torch.autograd.grad((y * T_(dy)).sum(), (xt,))
    want = ref.ssd_scan_bwd_ref(*map(T_, (x, dt, a, bm, cm)), T_(dy), None,
                                chunk=8)[0]
    assert _rel(gx, want) <= 1e-6
    with torch.no_grad():
        y, _ = ops.ssd_scan(xt, *map(T_, (dt, a, bm, cm)), chunk=8)
    assert y.grad_fn is None


def test_expert_gemm_function_passes_gradcheck_in_f64():
    gen = torch.Generator().manual_seed(5)
    xe = torch.randn(3, 5, 7, dtype=torch.float64, generator=gen,
                     requires_grad=True)
    w = torch.randn(3, 7, 4, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert type(ops.expert_gemm(xe, w).grad_fn).__name__ == \
        "ExpertGemmBackward"
    assert torch.autograd.gradcheck(ops.expert_gemm, (xe, w))


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_expert_gemm_function_matches_autograd_on_cpu(needs):
    rng = np.random.default_rng(6)
    xe, w, dy = (T_(rng.standard_normal(s).astype(np.float32))
                 for s in ((4, 9, 16), (4, 16, 12), (4, 9, 12)))
    xf, wf = xe.clone().requires_grad_(needs[0]), \
        w.clone().requires_grad_(needs[1])
    out = ops.expert_gemm(xf, wf)
    leaves = [t for t, n in zip((xf, wf), needs) if n]
    got = torch.autograd.grad((out * dy).sum(), leaves)
    xr, wr = xe.clone().requires_grad_(needs[0]), \
        w.clone().requires_grad_(needs[1])
    want = torch.autograd.grad(
        (torch.einsum("ecd,edf->ecf", xr, wr) * dy).sum(),
        [t for t, n in zip((xr, wr), needs) if n])
    for u, v in zip(got, want):
        assert _rel(u, v) <= 1e-6
