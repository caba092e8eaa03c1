"""What the training slice left out, on the CPU: frequent-token routing
(``core/routing/frequent.py``) against the JAX package's at 1e-5 with the
same chunk choices, and the in-place AdamW update (and the vector
trainer's in-place outer step) against the functional ones, bit for
bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core.routing import discriminative as jdisc
from repro.core.routing import frequent as jfreq
from repro.core.routing import kmeans as jkmeans
from repro.models import api as japi
from repro_torch.configs import get_smoke_config
from repro_torch.core.routing import (DiscriminativeRouter, KMeansRouter,
                                      chunk_choices, evaluate_rerouted,
                                      per_token_nll)
from repro_torch.models import api
from repro_torch.models.params import (from_numpy_tree, to_numpy_tree,
                                       tree_leaves, tree_map)
from repro_torch.optim import adamw_init, adamw_update, adamw_update_

EVERY = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tiny_docs):
    """Two paths (the smoke weights, and the same plus noise), the base
    as feature model, 6 documents of 40 tokens, a discriminative router
    and a k-means router over 8-token chunk features, in both packages."""
    jcfg = jget_smoke("dipaco-150m").replace(route_prefix_len=8,
                                             attn_impl="chunked")
    cfg = get_smoke_config("dipaco-150m").replace(route_prefix_len=8,
                                                  attn_impl="pallas")
    jbase = _np(japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    rng = np.random.default_rng(0)
    other = jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.02).astype(x.dtype),
        jbase)
    paths = [jbase, other]
    tokens = tiny_docs[0][:6, :40]
    d = jcfg.d_model
    w = rng.standard_normal((d, 2)).astype(np.float32)
    b = np.asarray([0.1, -0.1], np.float32)
    mu = rng.standard_normal(d).astype(np.float32) * 0.1
    sigma = (np.abs(rng.standard_normal(d)) + 0.5).astype(np.float32)
    cents = rng.standard_normal((2, d)).astype(np.float32)
    return {
        "jcfg": jcfg, "cfg": cfg, "tokens": tokens,
        "jpaths": [jax.tree_util.tree_map(jnp.asarray, p) for p in paths],
        "tpaths": [from_numpy_tree(p, device="cpu") for p in paths],
        "jrouters": {
            "disc": jdisc.DiscriminativeRouter(*map(jnp.asarray,
                                                    (w, b, mu, sigma))),
            "kmeans": _JKMeans(jnp.asarray(cents))},
        "trouters": {
            "disc": DiscriminativeRouter(*map(torch.from_numpy,
                                              (w, b, mu, sigma))),
            "kmeans": KMeansRouter(torch.from_numpy(cents))}}


class _JKMeans:
    """Eq. 1 as a router in the reference (it has no router class)."""

    def __init__(self, c):
        self.c = c

    def assign(self, z):
        return jkmeans.kmeans_assign(z, self.c)[0]


def test_per_token_nll_matches_reference(setup):
    s = setup
    mine = per_token_nll(s["tpaths"], s["cfg"], s["tokens"], batch_size=4)
    theirs = jfreq.per_token_nll(s["jpaths"], s["jcfg"],
                                 jnp.asarray(s["tokens"]), batch_size=4)
    assert tuple(mine.shape) == tuple(theirs.shape) == (2, 6, 39)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("router", ["disc", "kmeans"])
def test_chunk_choices_and_rerouted_eval_match_reference(setup, router):
    s = setup
    tc, tstarts = chunk_choices(s["trouters"][router], s["tpaths"][0],
                                s["cfg"], s["tokens"], every=EVERY,
                                batch_size=4)
    jc, jstarts = jfreq.chunk_choices(s["jrouters"][router], s["jpaths"][0],
                                      s["jcfg"], jnp.asarray(s["tokens"]),
                                      every=EVERY, batch_size=4)
    assert tstarts == jstarts == [8, 16, 24, 32]
    np.testing.assert_array_equal(tc, np.asarray(jc))
    assert len(np.unique(tc)) == 2          # both paths are chosen
    mine = evaluate_rerouted(s["tpaths"], s["cfg"], s["trouters"][router],
                             s["tpaths"][0], s["tokens"], every=EVERY,
                             batch_size=4)
    theirs = jfreq.evaluate_rerouted(s["jpaths"], s["jcfg"],
                                     s["jrouters"][router], s["jpaths"][0],
                                     jnp.asarray(s["tokens"]), every=EVERY,
                                     batch_size=4)
    assert mine.keys() == theirs.keys()
    np.testing.assert_allclose(mine["nll"], theirs["nll"], rtol=1e-5)
    np.testing.assert_allclose(mine["ppl"], theirs["ppl"], rtol=1e-5)
    assert mine["switch_rate"] == theirs["switch_rate"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None, 1e-3])
def test_adamw_update_in_place_equals_functional(dtype, clip):
    """Three steps: the same bits in the weights and both moments."""
    cfg = get_smoke_config("dipaco-150m").replace(dtype=dtype)
    params = api.init_model(cfg, seed=0, device="cpu")
    mine = tree_map(torch.clone, params)
    st_f, st_i = adamw_init(params), adamw_init(params)
    gen = torch.Generator().manual_seed(0)
    for step in range(3):
        grads = tree_map(lambda x: torch.randn(
            x.shape, generator=gen).to(x.dtype), params)
        lr = torch.tensor(1e-3 * (step + 1))
        params, st_f = adamw_update(grads, st_f, params, lr=lr,
                                    grad_clip=clip)
        adamw_update_(grads, st_i, mine, lr=lr, grad_clip=clip)
    for a, b in zip(tree_leaves(params), tree_leaves(mine)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(st_f[k]), tree_leaves(st_i[k])):
            assert torch.equal(a, b)
    assert int(st_i["count"]) == int(st_f["count"]) == 3


def test_adamw_in_place_pairs_leaves_by_key():
    """A tree built in another key order updates the same leaves (the
    checkpoint plane rebuilds trees in sorted-key order)."""
    p = {"b": torch.ones(3), "a": torch.full((2,), 2.0)}
    g = {"a": torch.full((2,), 0.5), "b": torch.full((3,), -0.5)}
    st = adamw_init(p)
    want, _ = adamw_update(g, adamw_init(p), p, lr=0.1)
    adamw_update_(g, st, p, lr=0.1)
    for k in p:
        assert torch.equal(p[k], want[k])
    assert to_numpy_tree(st["m"])["a"].shape == (2,)


@pytest.mark.parametrize("slab", [1 << 24, 64])
def test_in_place_steps_equal_functional_in_slabs(monkeypatch, slab):
    """The vector trainer's in-place AdamW and outer steps, whole and in
    slabs of 64 elements, against the functional steps."""
    from repro_torch.core import diloco
    from repro_torch.core.dipaco import stack_tree
    from repro_torch.core.partition import make_partition, mixing_matrices
    from repro_torch.models.config import DiPaCoConfig
    from repro_torch.models.params import param_axes
    from repro_torch.optim import adamw as adamw_mod
    monkeypatch.setattr(adamw_mod, "SLAB_ELEMS", slab)
    cfg = get_smoke_config("dipaco-150m")
    base = api.init_model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    noise = lambda x: torch.randn(x.shape, generator=gen) * 0.01  # noqa: E731
    W = 4
    worker = tree_map(lambda x: x + noise(x), stack_tree(base, W))
    glob = stack_tree(base, W)
    st = diloco.outer_state_init(glob)
    st["momentum"] = tree_map(lambda x: x + noise(x), st["momentum"])
    part = make_partition(DiPaCoConfig(levels=(2, 2)), cfg.pattern_repeats)
    ml, ms = (torch.as_tensor(m) for m in mixing_matrices(
        part, np.arange(W), np.asarray([0.1, 0.2, 0.3, 0.4])))
    axes = param_axes(cfg)
    nw, ng, ns = diloco.outer_step(worker, glob, st, axes, ml, ms)
    w2, g2, s2 = (tree_map(torch.clone, t) for t in (worker, glob, st))
    diloco.outer_step_(w2, g2, s2, axes, ml, ms)
    # whole leaves: the same bits; in slabs the mixing's matrix product
    # may add a shared leaf's W terms in another order (1e-6)
    for a, b in ((nw, w2), (ng, g2), (ns["momentum"], s2["momentum"])):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            if slab == 1 << 24:
                assert torch.equal(x, y)
            else:
                torch.testing.assert_close(x, y, atol=1e-6, rtol=0)
    # AdamW in slabs
    p = tree_map(torch.clone, base)
    grads = tree_map(lambda x: noise(x) * 100, base)
    want, _ = adamw_update(grads, adamw_init(p), p, lr=1e-3)
    adamw_update_(grads, adamw_init(p), p, lr=1e-3)
    for x, y in zip(tree_leaves(want), tree_leaves(p)):
        assert torch.equal(x, y)
