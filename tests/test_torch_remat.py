"""Activation checkpointing per layer group (``cfg.remat``) in the port's
model, on the CPU in f32, against the port without remat and against the
JAX reference with ``remat=True`` (``repro/models/lm.py``'s
``jax.checkpoint`` of its scan body), on the same weights and tokens.

The gradients of both policies equal the ones without remat (1e-6:
the recompute repeats the forward's arithmetic, so only the order of the
backward's sums may differ) and the reference's (1e-5, as the model
parity tests).  The recompute itself is counted: with remat every block
runs twice in a forward + backward, and once everywhere else."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models.params import (from_numpy_tree, to_numpy_tree,
                                       tree_leaves)

SAME_TOL = 1e-6
REF_TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jsmoke("dipaco-150m").replace(remat=True, attn_impl="chunked")
    jp = jax.tree_util.tree_map(
        np.asarray, japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    jgrads = jax.grad(lambda p: japi.forward_loss(
        p, jcfg, {"tokens": jnp.asarray(tokens)})[0])(
            jax.tree_util.tree_map(jnp.asarray, jp))
    return jp, tokens, jax.tree_util.tree_map(np.asarray, jgrads)


def _port_grads(jp, tokens, **kw):
    cfg = tsmoke("dipaco-150m").replace(**kw)
    _, _, grads = value_and_grad(from_numpy_tree(jp, device="cpu"), cfg,
                                 {"tokens": torch.from_numpy(tokens)})
    return grads


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: np.asarray(tree)}


def _max_diff(mine, theirs) -> float:
    a, b = _flat(mine), _flat(theirs)
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


class _WeightProducts(TorchDispatchMode):
    """Counts the ``mm`` / ``addmm`` calls that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_no_remat_and_reference(setup, impl, policy):
    """``pallas`` sends attention through the ``FlashAttention`` Function
    (its plain versions on the CPU), so the recompute also re-runs the
    custom Function's forward."""
    jp, tokens, jgrads = setup
    plain = _port_grads(jp, tokens, attn_impl=impl, remat=False)
    remat = _port_grads(jp, tokens, attn_impl=impl, remat=True,
                        remat_policy=policy)
    assert _max_diff(remat, plain) <= SAME_TOL
    assert _max_diff(remat, jgrads) <= REF_TOL


@pytest.fixture
def block_calls(monkeypatch):
    calls = []
    apply_block = tlm._apply_block

    def counted(*args, **kwargs):
        calls.append(1)
        return apply_block(*args, **kwargs)

    monkeypatch.setattr(tlm, "_apply_block", counted)
    return calls


def _backward_products(params, cfg, tokens) -> int:
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss, _ = tapi.forward_loss(params, cfg,
                                {"tokens": torch.from_numpy(tokens)})
    with _WeightProducts() as products:
        torch.autograd.grad(loss, leaves)
    return products.count


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_runs_every_block_twice_in_forward_and_backward(
        setup, block_calls, policy):
    """Each block's forward runs again in the backward.  ``"full"``
    recomputes the weight products there too; ``"dots"`` takes them from
    the forward, so its backward runs as many as the one without remat."""
    jp, tokens, _ = setup
    cfg = tsmoke("dipaco-150m").replace(remat=True, remat_policy=policy)
    plain = _backward_products(from_numpy_tree(jp, device="cpu"),
                               cfg.replace(remat=False), tokens)
    del block_calls[:]
    remat = _backward_products(from_numpy_tree(jp, device="cpu"), cfg,
                               tokens)
    assert len(block_calls) == 2 * cfg.num_layers
    if policy == "dots":
        assert remat == plain
    else:
        assert remat > plain


@pytest.mark.parametrize("mode", ["remat_off", "no_grad", "inference_mode",
                                  "prefill_decode"])
def test_blocks_run_once_without_remat_or_gradients(setup, block_calls,
                                                    mode):
    """Serving (prefill, decode) and any call without gradients keep one
    forward per block, remat on or off."""
    jp, tokens, _ = setup
    cfg = tsmoke("dipaco-150m").replace(remat=mode != "remat_off")
    params = from_numpy_tree(jp, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    if mode == "remat_off":
        leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
        loss, _ = tapi.forward_loss(params, cfg, batch)
        torch.autograd.grad(loss, leaves)
        assert len(block_calls) == cfg.num_layers
    elif mode == "no_grad":
        with torch.no_grad():
            tapi.forward_loss(params, cfg, batch)
        assert len(block_calls) == cfg.num_layers
    elif mode == "inference_mode":
        with torch.inference_mode():
            tapi.forward_loss(params, cfg, batch)
        assert len(block_calls) == cfg.num_layers
    else:
        toks = batch["tokens"]
        _, cache = tapi.prefill(params, cfg, {"tokens": toks[:, :8]}, 16)
        assert len(block_calls) == cfg.num_layers
        ci = torch.full((toks.shape[0],), 8, dtype=torch.int32)
        tapi.serve_step(params, cfg, {"tokens": toks[:, 8:9]}, cache, ci)
        assert len(block_calls) == 2 * cfg.num_layers
