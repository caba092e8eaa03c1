"""One inner training step of the SSM and token-MoE families on the CPU in
f32 at smoke size: the port at ``attn_impl="pallas"`` (the ``SSDScan``,
``ExpertGemm`` and ``FlashAttention`` Functions over the plain forwards
and backwards) against the reference's ``jax.grad`` of ``forward_loss``
and its AdamW step, on the same numpy-seeded weights and tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.launch.steps import make_inner_train_step as jinner_step
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch.steps import make_inner_train_step
from repro_torch.models.params import (from_numpy_tree, to_numpy_tree,
                                       tree_map)
from repro_torch.optim import adamw_init


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this module: under pytest-xdist each worker
    would otherwise start a thread pool as wide as the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


# (arch, tokens a document): mamba2-1.3b's smoke chunk is 64, so 96
# tokens make two chunks, the second padded (dt = 0)
@pytest.mark.parametrize("arch,seq", [("mamba2-1.3b", 96),
                                      ("qwen2-moe-a2.7b", 48)])
def test_family_inner_step_matches_reference(arch, seq):
    """W = 2 workers from different weights on different batches.  The
    loss agrees to 1e-6, AdamW's first moment ((1 - b1) g) to 1e-7 of
    absolute difference, the parameters to 1e-5 after a step of lr 1e-3,
    except where a gradient element is below 1e-6 (AdamW's first step is
    lr * g / (|g| + 1e-8), which turns such a gradient's f32 rounding into
    up to lr of movement; there, under 1% of the elements, to lr)."""
    jcfg = jsmoke(arch)
    tcfg = tsmoke(arch).replace(attn_impl="pallas")
    W, lr = 2, 1e-3
    base = _np(japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    rng = np.random.default_rng(4)
    wp = jax.tree_util.tree_map(
        lambda b: (b[None] + 0.01 * rng.standard_normal((W,) + b.shape))
        .astype(b.dtype), base)
    batch = rng.integers(0, jcfg.vocab_size, (W, 2, seq)).astype(np.int32)
    jwp = jax.tree_util.tree_map(jnp.asarray, wp)
    jnew, jopt, jm = jinner_step(jcfg)(
        jwp, jax.vmap(jadamw.adamw_init)(jwp), {"tokens": jnp.asarray(batch)},
        jnp.float32(lr))
    twp = from_numpy_tree(wp, device="cpu")
    topt = tree_map(lambda x: x[None].repeat(W, *([1] * x.ndim)),
                    adamw_init(from_numpy_tree(base, device="cpu")))
    tnew, tstate, tm = make_inner_train_step(tcfg)(
        twp, topt, {"tokens": torch.from_numpy(batch)}, torch.tensor(lr))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-6)
    m, jmom = _flat(to_numpy_tree(tstate["m"])), _flat(_np(jopt["m"]))
    new, jn = _flat(to_numpy_tree(tnew)), _flat(_np(jnew))
    assert m.keys() == jmom.keys() == new.keys() == jn.keys()
    tiny = 0
    for k in new:
        np.testing.assert_allclose(m[k], jmom[k], atol=1e-7, rtol=0,
                                   err_msg=k)
        g = np.minimum(np.abs(m[k]), np.abs(jmom[k])) / 0.1
        tol = np.where(g < 1e-6, lr, 1e-5)
        tiny += int((g < 1e-6).sum())
        assert (np.abs(new[k] - jn[k]) <= tol).all(), k
    assert tiny <= 1e-2 * sum(x.size for x in new.values())
