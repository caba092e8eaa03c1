"""The port's SSM and token-MoE layers against the JAX package in fp32 on
the CPU: the plain versions of the SSD-scan and expert-GEMM kernels
against the Pallas kernels in interpret mode and the reference's
``ssd_chunked``, ``apply_mamba`` prefill and decode, both MoE dispatches,
the parameter axes and bridge of the new leaves, and the per-layer cast
of ``init_lm``.  Inputs are made with numpy from a seed; weights come
from ``repro.models.api.init_model`` through ``from_numpy_tree``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import moe_layer as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.kernels import ops, ref
from repro_torch.models import api as tapi
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models import moe_layer as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.params import (cast_tree, from_numpy_tree,
                                       param_axes, to_numpy_tree)

ATOL = 1e-5
T_ = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this module: under pytest-xdist each worker
    would otherwise start a thread pool as wide as the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=atol)


def _bridge(tree):
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _ssd_inputs(seed, b, s, h, p, g, n):
    """x, dt (softplus of a shifted normal, as the model's), A (-1..-h)
    and grouped B, C, all f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0)).astype(
        np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32) / 2
    bm = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    return x, dt, a, bm, cm


# (B, S, H, P, G, N, chunk): one chunk, several chunks, groups, a chunk
# length that is not a power of two
SSD_CASES = [(2, 32, 4, 16, 1, 16, 32), (2, 96, 4, 16, 2, 8, 32),
             (1, 60, 6, 8, 3, 16, 12), (2, 64, 2, 32, 1, 32, 64)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_scan_ref_matches_pallas_interpret(b, s, h, p, g, n, chunk):
    """The plain version takes B and C grouped; the Pallas kernel takes
    them broadcast to every head."""
    x, dt, a, bm, cm = _ssd_inputs(0, b, s, h, p, g, n)
    y, _ = ref.ssd_scan_ref(*map(T_, (x, dt, a, bm, cm)), chunk=chunk)
    rep = h // g
    jy = jops.ssd_scan(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                       jnp.asarray(np.repeat(bm, rep, axis=2)),
                       jnp.asarray(np.repeat(cm, rep, axis=2)), chunk=chunk,
                       interpret=True)
    _close(y, jy)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_scan_ref_matches_ssd_chunked(b, s, h, p, g, n, chunk):
    """y and the final state, through ``ops`` (a CPU tensor takes the
    plain version), against the reference's chunked SSD."""
    x, dt, a, bm, cm = _ssd_inputs(1, b, s, h, p, g, n)
    y, state = ops.ssd_scan(*map(T_, (x, dt, a, bm, cm)), chunk=chunk)
    jy, jstate = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)),
                                  chunk)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    _close(y, jy)
    _close(state, jstate)


@pytest.mark.parametrize("e,c,d,f", [(4, 8, 32, 48), (3, 21, 64, 40),
                                     (2, 64, 128, 64)])
def test_expert_gemm_ref_matches_pallas_interpret(e, c, d, f):
    rng = np.random.default_rng(2)
    xe = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    out = ops.expert_gemm(T_(xe), T_(w))
    jout = jops.expert_gemm(jnp.asarray(xe), jnp.asarray(w), interpret=True)
    assert out.shape == (e, c, f) and out.dtype == torch.float32
    _close(out, jout, atol=1e-4)        # sums of d products of size ~1


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------
def _mamba_pair(attn_impl, **ssm_kw):
    jcfg = jsmoke("mamba2-1.3b")
    tcfg = tsmoke("mamba2-1.3b").replace(attn_impl=attn_impl)
    jcfg = jcfg.replace(ssm=dataclasses.replace(jcfg.ssm, **ssm_kw))
    tcfg = tcfg.replace(ssm=dataclasses.replace(tcfg.ssm, **ssm_kw))
    jp, _ = jssm.init_mamba(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
@pytest.mark.parametrize("s,groups", [(40, 1), (128, 1), (2, 2), (70, 4)])
def test_apply_mamba_prefill_and_decode_match(attn_impl, s, groups):
    """Prefill (chunk padding when S is not a chunk multiple, S shorter
    than the conv width), its state, then decode steps from that state."""
    jcfg, tcfg, jp, tp = _mamba_pair(attn_impl, n_groups=groups)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, s + 3, tcfg.d_model)).astype(np.float32)
    jy, jst = jssm.apply_mamba(jp, jcfg, jnp.asarray(u[:, :s]),
                               return_state=True)
    ty, tst = tssm.apply_mamba(tp, tcfg, T_(u[:, :s]), return_state=True)
    _close(ty, jy)
    for k in ("conv", "ssm"):
        _close(tst[k], jst[k])
    jy0, _ = jssm.apply_mamba(jp, jcfg, jnp.asarray(u[:, :s]))
    ty0, none = tssm.apply_mamba(tp, tcfg, T_(u[:, :s]))
    assert none is None
    _close(ty0, jy0)
    for t in range(s, s + 3):
        jy, jst = jssm.apply_mamba(jp, jcfg, jnp.asarray(u[:, t:t + 1]),
                                   state=jst)
        ty, tst = tssm.apply_mamba(tp, tcfg, T_(u[:, t:t + 1]), state=tst)
        _close(ty, jy)
        _close(tst["ssm"], jst["ssm"])
        _close(tst["conv"], jst["conv"])


def _moe_pair(mlp_type="swiglu", attn_impl="chunked", impl="dense",
              shared=2):
    moe_kw = dict(impl=impl, num_shared=shared,
                  d_ff_shared=256 if shared else 0)
    jcfg = jsmoke("qwen2-moe-a2.7b")
    jcfg = jcfg.replace(mlp_type=mlp_type,
                        moe=dataclasses.replace(jcfg.moe, **moe_kw))
    tcfg = tsmoke("qwen2-moe-a2.7b")
    tcfg = tcfg.replace(mlp_type=mlp_type, attn_impl=attn_impl,
                        moe=dataclasses.replace(tcfg.moe, **moe_kw))
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(5), jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


@pytest.mark.parametrize("impl", ["dense", "scatter"])
@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
@pytest.mark.parametrize("mlp_type,shared", [("swiglu", 2), ("gelu", 0),
                                             ("relu2", 0), ("geglu", 2)])
@pytest.mark.parametrize("b,s", [(2, 4), (4, 300)])
def test_moe_dispatch_matches(impl, attn_impl, mlp_type, shared, b, s):
    """y and aux of both dispatches: a decode-sized batch (one group,
    dropless capacity) and 1200 tokens (two groups with padding; capacity
    drops tokens)."""
    jcfg, tcfg, jp, tp = _moe_pair(mlp_type, attn_impl, impl, shared)
    x = np.random.default_rng(6).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    fn = {"dense": (jmoe.moe_dense_dispatch, tmoe.moe_dense_dispatch),
          "scatter": (jmoe.moe_scatter_dispatch,
                      tmoe.moe_scatter_dispatch)}[impl]
    jy, jaux = fn[0](jp, jcfg, jnp.asarray(x))
    ty, taux = fn[1](tp, tcfg, T_(x))
    _close(ty, jy)
    _close(taux, jaux)
    ay, aaux = tmoe.apply_moe(tp, tcfg, T_(x))
    assert torch.equal(ay, ty) and torch.equal(aaux, taux)


def test_router_topk_matches():
    jcfg, tcfg, jp, tp = _moe_pair()
    x = np.random.default_rng(7).standard_normal((50, tcfg.d_model)).astype(
        np.float32)
    jg, ji, jaux = jmoe._router_topk(jp, jcfg.moe, jnp.asarray(x))
    tg, ti, taux = tmoe._router_topk(tp, tcfg.moe, T_(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    _close(taux, jaux)


# ---------------------------------------------------------------------------
# Parameters: axes, the bridge, and the per-layer cast of init_lm
# ---------------------------------------------------------------------------
NEW_FAMILIES = ["mamba2-1.3b", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_param_axes_and_tree_equal_reference(name):
    jcfg, tcfg = jsmoke(name), tsmoke(name)
    jp, jaxes = japi.init_model(jax.random.PRNGKey(0), jcfg)
    assert param_axes(tcfg) == jaxes
    mine = to_numpy_tree(tapi.init_model(tcfg, seed=0, device="cpu"))
    theirs = jax.tree_util.tree_map(np.asarray, jp)
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [k for k, _ in flat_m] == [k for k, _ in flat_t]
    for (k, a), (_, b) in zip(flat_m, flat_t):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_bridge_roundtrip_of_new_leaves_is_bit_exact(name):
    cfg = jsmoke(name).replace(dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, japi.init_model(jax.random.PRNGKey(1), cfg)[0])
    back = to_numpy_tree(from_numpy_tree(tree, device="cpu"))
    leaves_a = jax.tree_util.tree_leaves(tree)
    leaves_b = jax.tree_util.tree_leaves(back)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _init_lm_stack_then_cast(gen, cfg):
    """``init_lm`` as it was before each leaf was cast when drawn: every
    layer drawn in f32 (``randn * scale``), the layers stacked in f32,
    then the whole tree cast."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    reps = cfg.pattern_repeats
    params = {"embed": tl.init_embedding(gen, cfg)}
    params["blocks"] = {
        f"pos{i}": stack([tlm._init_block(gen, cfg, spec)
                          for _ in range(reps)])
        for i, spec in enumerate(cfg.pattern)}
    params["final_norm"] = tl.init_rmsnorm(gen, cfg.d_model)
    return cast_tree(params, tl.torch_dtype(cfg.dtype))


@pytest.mark.parametrize("full_width", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_model_bit_for_bit_as_before_the_per_layer_cast(
        monkeypatch, full_width, dtype):
    """dipaco-150m: the same seed gives the same tree, bit for bit, as
    drawing every layer in f32, stacking and then casting (the smoke
    config, and the full width at 2 layers)."""
    cfg = tsmoke("dipaco-150m")
    if full_width:
        from repro_torch.configs import get_config
        cfg = get_config("dipaco-150m").replace(num_layers=2)
    cfg = cfg.replace(dtype=dtype)
    mine = tapi.init_model(cfg, seed=3, device="cpu")
    monkeypatch.setattr(tl, "_normal", lambda gen, shape, scale: torch.randn(
        shape, generator=gen, device=gen.device) * scale)
    old = _init_lm_stack_then_cast(torch.Generator().manual_seed(3), cfg)
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_o = jax.tree_util.tree_flatten_with_path(old)[0]
    assert [k for k, _ in flat_m] == [k for k, _ in flat_o]
    for (k, a), (_, b) in zip(flat_m, flat_o):
        assert a.dtype == b.dtype == tl.torch_dtype(dtype), k
        assert torch.equal(a.view(torch.int16) if dtype == "bfloat16" else a,
                           b.view(torch.int16) if dtype == "bfloat16" else b), k


def test_kernel_wrappers_refuse_cpu_tensors_and_ops_other_devices():
    from repro_torch.kernels.moe_gmm import expert_gemm
    from repro_torch.kernels.ssd_scan import ssd_scan
    x = torch.zeros(1, 4, 2, 32)
    dt = torch.zeros(1, 4, 2)
    bm = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, dt, torch.zeros(2), bm, bm, chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        expert_gemm(x[0], x[0].transpose(1, 2).contiguous())
    assert ssd_scan.launches == 0 and expert_gemm.launches == 0
    # a meta tensor (the dry-run's) takes the plain version's shapes; a
    # tensor on another device (an XPU stand-in: this build can make no
    # such tensor) has no kernel
    meta = torch.zeros(2, 4, 8, device="meta")
    assert ops.expert_gemm(meta, meta.transpose(1, 2)).shape == (2, 4, 4)

    class OnXpu:
        device = torch.device("xpu")
        requires_grad = False

    other = OnXpu()
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.expert_gemm(other, other)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd_scan(other, dt, torch.zeros(2), bm, bm, chunk=4)


def test_cpu_ops_stay_differentiable():
    """On the CPU an input that requires a gradient goes through the
    SSDScan and ExpertGemm Functions over the plain forwards and plain
    backwards (on the card, over the kernels)."""
    x, dt, a, bm, cm = (T_(t).requires_grad_(True)
                        for t in _ssd_inputs(8, 1, 16, 2, 16, 1, 16))
    y, state = ops.ssd_scan(x, dt, a, bm, cm, chunk=8)
    (y.sum() + state.sum()).backward()
    assert all(t.grad is not None for t in (x, dt, a, bm, cm))
    xe = torch.randn(2, 3, 4, requires_grad=True)
    w = torch.randn(2, 4, 5, requires_grad=True)
    ops.expert_gemm(xe, w).sum().backward()
    assert xe.grad is not None and w.grad is not None
