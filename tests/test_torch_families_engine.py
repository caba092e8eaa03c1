"""The one-shot engine and the training gradients of the port's other
decoder families against the JAX package in fp32 on the CPU at smoke
size (``dipaco-dense-1b``, ``qwen3-8b``, ``pixtral-12b``,
``moonshot-v1-16b-a3b``, ``jamba-v0.1-52b``, ``gemma-2b``,
``nemotron-4-340b``, ``qwen3-moe-235b-a22b``): greedy tokens and routed
paths with re-routing, and ``forward_loss`` gradients leaf by leaf, on
the reference's ``init_model`` weights bridged to torch.  The rest of
the families' parity is in ``test_torch_families.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.routing.discriminative import \
    DiscriminativeRouter as JRouter
from repro.core.routing.features import prefix_features as jfeats
from repro.models import api as japi
from repro.serving import EngineOptions as JOptions
from repro.serving import PathServingEngine as JEngine
from repro_torch.core.routing import DiscriminativeRouter as TRouter
from repro_torch.data import SyntheticCorpus
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.params import to_numpy_tree
from repro_torch.serving import EngineOptions as TOptions
from repro_torch.serving import PathServingEngine as TEngine

from test_torch_families import (  # noqa: F401 (an autouse fixture)
    FAMILIES, _close, _flat, _one_torch_thread, _pair, _patches, _tokens,
    _weights)

# gradients: within 1e-5 of the leaf's largest reference gradient, or of
# 1 where that is smaller
GRAD_TOL = 1e-5
NUM_PATHS = 3


def _routers(feats: np.ndarray, seed: int = 0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((feats.shape[1], NUM_PATHS)).astype(np.float32)
    b = (0.1 * rng.standard_normal(NUM_PATHS)).astype(np.float32)
    mu = feats.mean(0)
    sigma = np.maximum(feats.std(0), 1e-6)
    return (JRouter(*(jnp.asarray(x) for x in (w, b, mu, sigma))),
            TRouter(*(torch.from_numpy(x) for x in (w, b, mu, sigma))))


@pytest.mark.parametrize("name", FAMILIES)
def test_oneshot_engine_tokens_match_reference(name):
    """The one-shot engine over 3 paths with a discriminative router,
    re-routing every 3 tokens: greedy tokens and routed paths equal the
    JAX engine's (pixtral serves text only, as the reference's engine
    does)."""
    jcfg, tcfg = _pair(name, attn_impl="pallas", route_prefix_len=8)
    jpaths, tpaths = zip(*(_weights(jcfg, seed=p) for p in range(NUM_PATHS)))
    prompts = SyntheticCorpus(vocab_size=jcfg.vocab_size, num_domains=4,
                              seq_len=12, seed=1).sample_documents(6)
    jr, tr = _routers(np.asarray(jfeats(jpaths[0], jcfg,
                                        jnp.asarray(prompts))))
    jeng = JEngine(jcfg, list(jpaths),
                   options=JOptions(router=jr, cache_len=20))
    teng = TEngine(tcfg, list(tpaths),
                   options=TOptions(router=tr, cache_len=20))
    jres = jeng.generate(prompts, max_new=6, reroute_every=3)
    tres = teng.generate(prompts, max_new=6, reroute_every=3)
    assert len(set(jres.paths.tolist())) > 1          # the router spreads
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.paths, jres.paths)
    assert tres.switches == jres.switches


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_loss_gradients_match(name):
    """``jax.grad`` of the reference's ``forward_loss`` (chunked) against
    the port's at ``attn_impl="pallas"`` (the FlashAttention, SSDScan and
    ExpertGemm Functions over their plain versions), leaf by leaf; the
    pixtral batch carries patch embeddings, so ``patch_proj`` has a
    gradient."""
    jcfg, tcfg = _pair(name)
    jp, tp = _weights(jcfg, seed=2)
    toks = _tokens(2, 2, 48 if name != "pixtral-12b" else 40,
                   jcfg.vocab_size)
    batch = {"tokens": toks}
    if jcfg.vision is not None:
        batch["patch_embeds"] = _patches(jcfg, 2)
    jgrads = jax.grad(lambda p: japi.forward_loss(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    loss, _, grads = value_and_grad(
        tp, tcfg.replace(attn_impl="pallas"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(loss, japi.forward_loss(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})[0])
    mine, theirs = _flat(to_numpy_tree(grads)), _flat(jgrads)
    assert mine.keys() == theirs.keys()
    for k in mine:
        scale = max(float(np.abs(theirs[k]).max()), 1e-30)
        assert float(np.abs(mine[k] - theirs[k]).max()) <= GRAD_TOL * max(
            scale, 1.0), k
    if jcfg.vision is not None:
        assert np.abs(mine["patch_proj"]).max() > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_launcher_runs_new_decoders_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--device", "cpu", "--paths", "2", "--requests",
          "3", "--prompt-len", "10", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "on cpu" in out and "request->path" in out


def test_train_launcher_trains_the_dense_baseline_on_cpu(capsys):
    """The paper's dense baseline at levels 1 (one path) through the
    training launcher."""
    from repro_torch.launch.train import main
    main(["--arch", "dipaco-dense-1b", "--device", "cpu", "--smoke",
          "--levels", "1", "--phases", "1", "--tau", "2"])
    out = capsys.readouterr().out
    assert "arch=dipaco-dense-1b" in out and "paths=1" in out
    assert "routed validation PPL" in out
