"""The port's SSM, token-MoE and hybrid decoders against the JAX package
in fp32 on the CPU: ``apply_lm`` logits, aux and loss, ``prefill`` then
decode steps at mixed (B,) positions with every cache leaf compared,
routing features, and the one-shot engine's greedy tokens and routed
paths with and without re-routing.  The families are ``mamba2-1.3b``,
``qwen2-moe-a2.7b`` and a hybrid built from ``dataclasses.asdict`` of the
reference's ``jamba-v0.1-52b`` smoke config: (mamba, moe) and (attn,
dense) blocks in one pattern, where the cache layouts meet."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core.routing.discriminative import \
    DiscriminativeRouter as JRouter
from repro.core.routing.features import prefix_features as jfeats
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving import EngineOptions as JOptions
from repro.serving import PathServingEngine as JEngine
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core.routing import DiscriminativeRouter as TRouter
from repro_torch.core.routing import prefix_features as tfeats
from repro_torch.data import SyntheticCorpus
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models.config import (BlockSpec, ModelConfig, MoEConfig,
                                       SSMConfig)
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving import EngineOptions as TOptions
from repro_torch.serving import PathServingEngine as TEngine

ATOL = 1e-5
FAMILIES = ["mamba2-1.3b", "qwen2-moe-a2.7b", "jamba-hybrid"]
NUM_PATHS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread in this module: under pytest-xdist each worker
    would otherwise start a thread pool as wide as the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_config(jcfg) -> ModelConfig:
    """The port's ModelConfig with the fields of a reference config."""
    d = dataclasses.asdict(jcfg)
    d["pattern"] = tuple(BlockSpec(**b) for b in d["pattern"])
    d["moe"] = MoEConfig(**d["moe"]) if d["moe"] else None
    d["ssm"] = SSMConfig(**d["ssm"]) if d["ssm"] else None
    assert d["encoder"] is None and d["vision"] is None
    return ModelConfig(**d)


def _pair(name, **kw):
    if name == "jamba-hybrid":
        jcfg = jsmoke("jamba-v0.1-52b").replace(**kw)
        return jcfg, _port_config(jcfg)
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


def test_hybrid_config_holds_both_block_kinds():
    _, tcfg = _pair("jamba-hybrid")
    assert set(tcfg.pattern) == {BlockSpec("mamba", "moe"),
                                 BlockSpec("attn", "dense")}
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        jsmoke("jamba-v0.1-52b"))


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", FAMILIES)
def test_apply_lm_logits_aux_and_loss_match(name, attn_impl):
    """S = 70: the Mamba blocks pad to their chunk of 64."""
    jcfg, tcfg = _pair(name, attn_impl=attn_impl)
    jp, tp = _weights(jcfg)
    toks = _tokens(0, 2, 70, jcfg.vocab_size)
    jlog, jaux = jlm.apply_lm(jp, jcfg, jnp.asarray(toks))
    tlog, taux = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks))
    _close(tlog, jlog)
    _close(taux, jaux)
    assert (float(taux) > 0) == (tcfg.moe is not None)
    jh, _ = jlm.apply_lm(jp, jcfg, jnp.asarray(toks), return_hidden=True)
    th, _ = tlm.apply_lm(tp, tcfg, torch.from_numpy(toks),
                         return_hidden=True)
    _close(th, jh)
    loss, parts = tapi.forward_loss(tp, tcfg,
                                    {"tokens": torch.from_numpy(toks)})
    jloss, jparts = japi.forward_loss(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(loss, jloss)
    _close(parts["aux_loss"], jparts["aux_loss"])
    _close(parts["lm_loss"], jparts["lm_loss"])


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_mixed_decode_matches(name, attn_impl):
    """prefill, then decode steps whose (B,) positions differ per row
    (the attention rows wrap a 16-slot ring); every cache leaf — KV, conv
    and SSM state — is compared at the end."""
    jcfg, tcfg = _pair(name, attn_impl=attn_impl)
    jp, tp = _weights(jcfg, seed=1)
    b, s, T, steps = 3, 10, 16, 10
    toks = _tokens(1, b, s + steps, jcfg.vocab_size)
    jlog, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks[:, :s]), T)
    tlog, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks[:, :s]), T)
    _close(tlog, jlog)
    base = np.asarray([s, s - 3, s - 1], np.int32)
    for t in range(steps):
        ci = base + t
        tok = toks[:, s + t:s + t + 1]
        jlog, jc = jlm.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                   jnp.asarray(ci))
        tlog, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                   torch.from_numpy(ci))
        _close(tlog, jlog)
    assert jc.keys() == tc.keys()
    for pos in jc:
        assert jc[pos].keys() == tc[pos].keys(), pos
        for leaf in jc[pos]:
            a, c = np.asarray(jc[pos][leaf]), tc[pos][leaf]
            assert c.shape == a.shape and str(c.dtype)[6:] == str(a.dtype)
            _close(c, a)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_cache_layout_matches(name):
    jcfg, tcfg = _pair(name, dtype="bfloat16")
    jc = jlm.init_decode_cache(jcfg, 2, 12)
    tc = tapi.init_serve_cache(tcfg, 2, 12, device="cpu")
    for pos in jc:
        for leaf in jc[pos]:
            a, c = jc[pos][leaf], tc[pos][leaf]
            assert tuple(c.shape) == a.shape, (pos, leaf)
            assert str(c.dtype)[6:] == str(a.dtype), (pos, leaf)
            assert not c.any()


def _routers(feats: np.ndarray, seed: int = 0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((feats.shape[1], NUM_PATHS)).astype(np.float32)
    b = (0.1 * rng.standard_normal(NUM_PATHS)).astype(np.float32)
    mu = feats.mean(0)
    sigma = np.maximum(feats.std(0), 1e-6)
    return (JRouter(*(jnp.asarray(x) for x in (w, b, mu, sigma))),
            TRouter(*(torch.from_numpy(x) for x in (w, b, mu, sigma))))


def _engines(name, attn_impl="pallas"):
    jcfg, tcfg = _pair(name, attn_impl=attn_impl, route_prefix_len=8)
    jpaths, tpaths = zip(*(_weights(jcfg, seed=p) for p in range(NUM_PATHS)))
    return jcfg, tcfg, list(jpaths), list(tpaths)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefix_features_match(name):
    jcfg, tcfg, jpaths, tpaths = _engines(name)
    docs = SyntheticCorpus(vocab_size=jcfg.vocab_size, num_domains=4,
                           seq_len=24, seed=0).sample_documents(10)
    zf = tfeats(tpaths[0], tcfg, docs, batch_size=4)
    _close(zf, jfeats(jpaths[0], jcfg, jnp.asarray(docs), batch_size=4))


@pytest.mark.parametrize("reroute_every", [0, 3])
@pytest.mark.parametrize("name", FAMILIES)
def test_generate_matches_reference_engine(name, reroute_every):
    """Greedy tokens and routed paths of the one-shot engine equal the
    JAX engine's; the cache replay runs the SSM recurrence and the MoE
    decode dispatch at every step."""
    jcfg, tcfg, jpaths, tpaths = _engines(name)
    prompts = SyntheticCorpus(vocab_size=jcfg.vocab_size, num_domains=4,
                              seq_len=12, seed=1).sample_documents(6)
    jr, tr = _routers(np.asarray(jfeats(jpaths[0], jcfg,
                                        jnp.asarray(prompts))))
    max_new, cache_len = 7, 20
    jeng = JEngine(jcfg, jpaths, options=JOptions(router=jr,
                                                  cache_len=cache_len))
    teng = TEngine(tcfg, tpaths, options=TOptions(router=tr,
                                                  cache_len=cache_len))
    assign = teng.route(prompts)
    np.testing.assert_array_equal(assign, jeng.route(prompts))
    assert len(set(assign.tolist())) > 1           # the router spreads
    jres = jeng.generate(prompts, max_new=max_new,
                         reroute_every=reroute_every)
    tres = teng.generate(prompts, max_new=max_new,
                         reroute_every=reroute_every)
    assert (jres.switches > 0) == bool(reroute_every)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.paths, jres.paths)
    assert tres.switches == jres.switches


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2-moe-a2.7b"])
def test_serve_launcher_runs_new_families_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--device", "cpu", "--paths", "2", "--requests",
          "3", "--prompt-len", "10", "--max-new", "4", "--reroute-every",
          "2"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "on cpu" in out and "request->path" in out
