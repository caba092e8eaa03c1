"""The port's other decoder families against the JAX package in fp32 on
the CPU at smoke size: ``dipaco-dense-1b`` (the paper's dense baseline),
``qwen3-8b`` (qk-norm, GQA, untied), ``pixtral-12b`` (and its patch
stub), ``moonshot-v1-16b-a3b`` (MoE with shared experts),
``jamba-v0.1-52b`` (Mamba / attention, MoE / dense), ``gemma-2b``
(GeGLU, ``embed_scale``, MQA, tied), ``nemotron-4-340b`` (squared-ReLU)
and ``qwen3-moe-235b-a22b`` (MoE 128 top-8 at full size, qk-norm).  ``apply_lm``
logits and loss, prefill then greedy decode steps, ``param_axes`` and
the tree, on the reference's ``init_model`` weights bridged to torch and
numpy-seeded inputs; the patch stub; one DiLoCo phase of the dense
baseline against the JAX vector trainer.  The one-shot engine's tokens
and the gradients are in ``test_torch_families_engine.py`` (split so
that each file runs well inside two minutes); the last three families at
their published head geometry in ``test_torch_families_heads.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_smoke_config as jsmoke
from repro.data import sharder as jsharder
from repro.models import api as japi
from repro.models import lm as jlm
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data import sharder
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import (from_numpy_tree, param_axes,
                                       to_numpy_tree)
from repro_torch.training import make_trainer

ATOL = 1e-5
FAMILIES = ["dipaco-dense-1b", "qwen3-8b", "pixtral-12b",
            "moonshot-v1-16b-a3b", "jamba-v0.1-52b", "gemma-2b",
            "nemotron-4-340b", "qwen3-moe-235b-a22b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this module: under pytest-xdist each worker
    would otherwise start a thread pool as wide as the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, **kw):
    return jsmoke(name).replace(**kw), tsmoke(name).replace(**kw)


def _np(x):
    return np.asarray(x, np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=atol)


def _weights(jcfg, seed=0):
    jp = japi.init_model(jax.random.PRNGKey(seed), jcfg)[0]
    return jp, from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _patches(cfg, b, seed=5):
    v = cfg.vision
    return np.random.default_rng(seed).standard_normal(
        (b, v.num_patches, v.d_patch)).astype(np.float32)


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", FAMILIES)
def test_apply_lm_logits_and_loss_match(name, attn_impl):
    """S = 70: jamba's Mamba blocks pad to their chunk of 64."""
    jcfg, tcfg = _pair(name, attn_impl=attn_impl)
    jp, tp = _weights(jcfg)
    toks = _tokens(0, 2, 70, jcfg.vocab_size)
    jlog, jaux = jlm.apply_lm(jp, jcfg, jnp.asarray(toks))
    tlog, taux = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks))
    _close(tlog, jlog)
    _close(taux, jaux)
    loss, parts = tapi.forward_loss(tp, tcfg,
                                    {"tokens": torch.from_numpy(toks)})
    jloss, jparts = japi.forward_loss(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(loss, jloss)
    _close(parts["lm_loss"], jparts["lm_loss"])


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_greedy_decodes_match(name, attn_impl):
    """prefill, then 4 greedy decode steps, each fed the reference's
    argmax: the logits within 1e-5 and the greedy tokens identical."""
    jcfg, tcfg = _pair(name, attn_impl=attn_impl)
    jp, tp = _weights(jcfg, seed=1)
    b, s, T = 3, 10, 16
    toks = _tokens(1, b, s, jcfg.vocab_size)
    jlog, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, T)
    tlog, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, T)
    _close(tlog, jlog)
    for t in range(4):
        nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tlog[:, -1], -1).numpy(), nxt)
        jlog, jc = japi.serve_step(jp, jcfg, {"tokens": jnp.asarray(
            nxt[:, None])}, jc, jnp.int32(s + t))
        tlog, tc = tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(
            nxt[:, None])}, tc, s + t)
        _close(tlog, jlog)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_param_axes_and_tree_match_reference(name, dtype):
    """``param_axes`` equals the axes the reference's ``init_model``
    returns, and the port's own ``init_model`` gives the reference tree's
    keys, shapes and dtypes."""
    jcfg, tcfg = _pair(name, dtype=dtype)
    jp, jaxes = japi.init_model(jax.random.PRNGKey(0), jcfg)
    assert param_axes(tcfg) == jaxes
    mine = _flat(to_numpy_tree(tapi.init_model(tcfg, seed=0, device="cpu")))
    theirs = _flat(jp)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
        assert mine[k].dtype == theirs[k].dtype, k


def test_patch_embeds_through_apply_lm_and_prefill():
    """pixtral's patch stub: the first num_patches positions take the
    projected patch embeddings, in the training forward and in prefill
    (then 2 decode steps), within 1e-5 of the reference."""
    jcfg, tcfg = _pair("pixtral-12b", attn_impl="pallas")
    jp, tp = _weights(jcfg, seed=3)
    n = jcfg.vision.num_patches
    toks = _tokens(3, 2, n + 8, jcfg.vocab_size)
    pe = _patches(jcfg, 2)
    jlog, _ = jlm.apply_lm(jp, jcfg, jnp.asarray(toks),
                           patch_embeds=jnp.asarray(pe))
    tlog, _ = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks),
                           patch_embeds=torch.from_numpy(pe))
    _close(tlog, jlog)
    text_only, _ = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks))
    assert float((text_only - tlog).abs().max()) > 1e-2   # patches count
    T = n + 12
    jlog, jc = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                       "patch_embeds": jnp.asarray(pe)}, T)
    tlog, tc = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                       "patch_embeds": torch.from_numpy(pe)},
                            T)
    _close(tlog, jlog)
    for t in range(2):
        nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
        jlog, jc = japi.serve_step(jp, jcfg, {"tokens": jnp.asarray(nxt)},
                                   jc, jnp.int32(n + 8 + t))
        tlog, tc = tapi.serve_step(tp, tcfg, {"tokens": torch.from_numpy(
            nxt)}, tc, n + 8 + t)
        _close(tlog, jlog)


def test_prompt_shorter_than_patches_refused_by_both():
    """A sequence shorter than the patch positions has no room for them:
    the port raises a ValueError naming both lengths, and the
    reference's ``dynamic_update_slice`` refuses the same input."""
    jcfg, tcfg = _pair("pixtral-12b")
    jp, tp = _weights(jcfg)
    n = jcfg.vision.num_patches
    toks = _tokens(4, 2, n - 1, jcfg.vocab_size)
    pe = _patches(jcfg, 2)
    with pytest.raises(ValueError, match=f"{n} patch positions .* {n - 1} "
                                         f"tokens"):
        tlm.apply_lm(tp, tcfg, torch.from_numpy(toks),
                     patch_embeds=torch.from_numpy(pe))
    with pytest.raises(ValueError, match="patch positions"):
        tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                "patch_embeds": torch.from_numpy(pe)}, n + 4)
    with pytest.raises(TypeError):
        jlm.apply_lm(jp, jcfg, jnp.asarray(toks),
                     patch_embeds=jnp.asarray(pe))


def test_dense_baseline_diloco_phase_matches_reference(tiny_docs):
    """One DiLoCo phase of tau = 3 of ``dipaco-dense-1b`` at levels (1,)
    (one path, one worker): the phase's loss, the worker's parameters and
    the module store against the JAX vector trainer."""
    docs, _ = tiny_docs
    jcfg, tcfg = _pair("dipaco-dense-1b", route_prefix_len=8)
    jp, tp = _weights(jcfg)
    dkw = dict(levels=(1,), inner_steps=3)
    common = dict(batch_size=4, peak_lr=3e-3, warmup=2, total_steps=3)
    one = np.zeros(len(docs), np.int64)
    jt = repro.make_trainer(jcfg.replace(attn_impl="chunked"),
                            JDiPaCoConfig(**dkw),
                            jsharder.shard_documents(docs, one, 1),
                            backend="vector", key=jax.random.PRNGKey(0),
                            base_params=jp, **common)
    tt = make_trainer(tcfg.replace(attn_impl="pallas"), DiPaCoConfig(**dkw),
                      sharder.shard_documents(docs, one, 1),
                      backend="vector", device="cpu", base_params=tp,
                      **common)
    assert tt.num_workers == 1
    jm, tm = jt.run_phase(), tt.run_phase()
    np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-5)
    np.testing.assert_allclose(tm.final_loss, jm.final_loss, rtol=1e-5)
    for mine, theirs in ((tt.worker_params, jt.worker_params),
                         (tt.global_params, jt.global_params)):
        a, b = _flat(to_numpy_tree(mine)), _flat(theirs)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=k)
