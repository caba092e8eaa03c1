"""The port's routing and one-shot serving engine against the JAX
package in fp32 on the CPU: prefix features, document scores, and
greedy generation with a router whose weights are copied — identical
tokens and routed paths, with and without §2.4.3 re-routing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core.routing.discriminative import \
    DiscriminativeRouter as JRouter
from repro.core.routing.discriminative import score_documents as jscore
from repro.core.routing.features import prefix_features as jfeats
from repro.models import api as japi
from repro.serving import EngineOptions as JOptions
from repro.serving import PathServingEngine as JEngine
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core.routing import DiscriminativeRouter as TRouter
from repro_torch.core.routing import prefix_features as tfeats
from repro_torch.core.routing import score_documents as tscore
from repro_torch.data import SyntheticCorpus
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving import EngineOptions as TOptions
from repro_torch.serving import PathServingEngine as TEngine

NUM_PATHS = 3


def _setup(**kw):
    jcfg = jsmoke("dipaco-150m").replace(route_prefix_len=8, **kw)
    tcfg = tsmoke("dipaco-150m").replace(route_prefix_len=8, **kw)
    jpaths = [japi.init_model(jax.random.PRNGKey(p), jcfg)[0]
              for p in range(NUM_PATHS)]
    tpaths = [from_numpy_tree(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu") for p in jpaths]
    return jcfg, tcfg, jpaths, tpaths


def _routers(feats: np.ndarray, seed: int = 0):
    """Identical routers on both sides: numpy-seeded weights over
    features normalized by their own mean and spread."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((feats.shape[1], NUM_PATHS)).astype(np.float32)
    b = (0.1 * rng.standard_normal(NUM_PATHS)).astype(np.float32)
    mu = feats.mean(0)
    sigma = np.maximum(feats.std(0), 1e-6)
    j = JRouter(*(jnp.asarray(x) for x in (w, b, mu, sigma)))
    t = TRouter(*(torch.from_numpy(x) for x in (w, b, mu, sigma)))
    return j, t


def _docs(vocab, n=6, seq_len=24, seed=0):
    return SyntheticCorpus(vocab_size=vocab, num_domains=4, seq_len=seq_len,
                           seed=seed).sample_documents(n)


@pytest.mark.parametrize("attn_impl", ["chunked", "pallas"])
def test_prefix_features_and_scores_match(attn_impl):
    jcfg, tcfg, jpaths, tpaths = _setup(attn_impl=attn_impl)
    docs = _docs(jcfg.vocab_size, n=10)
    zf = tfeats(tpaths[0], tcfg, docs, batch_size=4)
    np.testing.assert_allclose(
        zf.numpy(), np.asarray(jfeats(jpaths[0], jcfg, jnp.asarray(docs),
                                      batch_size=4)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tscore(tpaths, tcfg, docs, batch_size=4).numpy(),
        np.asarray(jscore(jpaths, jcfg, jnp.asarray(docs), batch_size=4)),
        atol=1e-3, rtol=1e-5)   # sums of ~16 log-likelihoods of size ~6
    jr, tr = _routers(zf.numpy())
    np.testing.assert_array_equal(tr.assign(zf).numpy(),
                                  np.asarray(jr.assign(jnp.asarray(
                                      zf.numpy()))))
    np.testing.assert_array_equal(
        tr.assign_topn(zf, 2).numpy(),
        np.asarray(jr.assign_topn(jnp.asarray(zf.numpy()), 2)))


@pytest.mark.parametrize("attn_impl,reroute_every", [
    ("chunked", 0), ("chunked", 3), ("pallas", 0), ("pallas", 3)])
def test_generate_matches_reference_engine(attn_impl, reroute_every):
    jcfg, tcfg, jpaths, tpaths = _setup(attn_impl=attn_impl)
    prompts = _docs(jcfg.vocab_size, n=6, seq_len=12)
    jr, tr = _routers(np.asarray(jfeats(jpaths[0], jcfg,
                                        jnp.asarray(prompts))))
    max_new, cache_len = 8, 20
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


def test_route_fn_and_unrouted_match():
    jcfg, tcfg, jpaths, tpaths = _setup()
    prompts = _docs(jcfg.vocab_size, n=4, seq_len=10)
    fn = lambda p: int(p[0]) % NUM_PATHS   # noqa: E731
    for jopt, topt in ((JOptions(route_fn=fn, cache_len=16),
                        TOptions(route_fn=fn, cache_len=16)),
                       (JOptions(cache_len=16), TOptions(cache_len=16))):
        jres = JEngine(jcfg, jpaths, options=jopt).generate(prompts, 4)
        tres = TEngine(tcfg, tpaths, options=topt).generate(prompts, 4)
        np.testing.assert_array_equal(tres.tokens, jres.tokens)
        np.testing.assert_array_equal(tres.paths, jres.paths)


def test_engine_options_not_ported_parts_raise(tmp_path):
    """``registry=`` is taken now (the deploy plane is ported), but not
    beside a path list; ``telemetry=`` records the continuous engine's
    ticks."""
    from repro_torch.obs import Telemetry, read_trace
    from repro_torch.serving import ContinuousBatchingEngine, Request
    with pytest.raises(ValueError, match="not both"):
        TOptions(router=object(), route_fn=lambda p: 0)
    _, tcfg, _, tpaths = _setup()
    with pytest.raises(ValueError, match="not both"):
        ContinuousBatchingEngine(tcfg, tpaths,
                                 options=TOptions(registry=object()))
    tel = Telemetry(tmp_path / "serve.jsonl", fresh=True)
    eng = ContinuousBatchingEngine(tcfg, tpaths, options=TOptions(
        cache_len=16, slots_per_path=1, telemetry=tel))
    eng.serve_trace([Request(rid=0, prompt=np.arange(8), max_new=2)])
    tel.close()
    ticks = [r for r in read_trace(tmp_path / "serve.jsonl")[0]
             if r.get("name") == "serve.tick"]
    assert len(ticks) == eng.ticks == 2
    assert ticks[-1]["args"] == {"tick": 2, "in_flight": 0, "finished": 1}


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--paths", "2", "--requests", "3",
          "--prompt-len", "10", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "on cpu" in out and "request->path" in out
