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


# (arch, tokens a document, published heads or None): mamba2-1.3b's
# smoke chunk is 64, so 96 tokens make two chunks, the second padded
# (dt = 0).  The last three families take their published heads (H, KH,
# D; d_model = H D) as tests/test_torch_families_heads.py builds them,
# so that the FlashAttention Function's backward runs at D 256, at D 192
# with 12 query heads a KV head and at D 128 with 16
@pytest.mark.parametrize("arch,seq,heads", [
    pytest.param("mamba2-1.3b", 96, None, id="mamba2-1.3b-96"),
    pytest.param("qwen2-moe-a2.7b", 48, None, id="qwen2-moe-a2.7b-48"),
    pytest.param("gemma-2b", 48, (8, 1, 256), id="gemma-2b-48-heads"),
    pytest.param("nemotron-4-340b", 48, (12, 1, 192),
                 id="nemotron-4-340b-48-heads"),
    pytest.param("qwen3-moe-235b-a22b", 48, (16, 1, 128),
                 id="qwen3-moe-235b-a22b-48-heads")])
def test_family_inner_step_matches_reference(arch, seq, heads):
    """W = 2 workers from different weights on different batches.  The
    loss agrees to 1e-6, AdamW's first moment ((1 - b1) g) to 1e-7 of
    absolute difference, the parameters to 1e-5 after a step of lr 1e-3,
    except where a gradient element is below 1e-6 (AdamW's first step is
    lr * g / (|g| + 1e-8), which turns such a gradient's f32 rounding into
    up to lr of movement; there, under 1% of the elements, to lr).

    At the published heads most of the embedding's rows have a gradient
    below 1e-6 (zero for a token no batch holds, or about 1e-14 under a
    saturated softmax), 4.3% of all elements at gemma-2b's, 5.0% at
    nemotron-4-340b's, 4.9% at qwen3-moe-235b-a22b's, so the 1% bound on
    their count cannot hold there.  In its place these three cases bound
    the elements that use the looser bar: under 1e-4 of all elements may
    have a gradient below 1e-6 and move more than 1e-5 from the
    reference's (1.7e-5, 1.7e-5 and 2.7e-5 of them do)."""
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    if heads is not None:
        h, kh, d = heads
        jcfg, tcfg = (c.replace(num_heads=h, num_kv_heads=kh, head_dim=d,
                                d_model=h * d) for c in (jcfg, tcfg))
    tcfg = tcfg.replace(attn_impl="pallas")
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
    tiny = loose = 0
    for k in new:
        np.testing.assert_allclose(m[k], jmom[k], atol=1e-7, rtol=0,
                                   err_msg=k)
        g = np.minimum(np.abs(m[k]), np.abs(jmom[k])) / 0.1
        tol = np.where(g < 1e-6, lr, 1e-5)
        diff = np.abs(new[k] - jn[k])
        tiny += int((g < 1e-6).sum())
        loose += int(((g < 1e-6) & (diff > 1e-5)).sum())
        assert (diff <= tol).all(), k
    size = sum(x.size for x in new.values())
    if heads is None:
        assert tiny <= 1e-2 * size, (tiny, size)
    else:
        assert loose <= 1e-4 * size, (tiny, loose, size)
