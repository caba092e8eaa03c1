"""The streaming part of the port's ``core/diloco.py`` against the JAX
package's, on the CPU in f32: per-fragment outer steps, per-row
quantization with error feedback, the fragment delta/apply functions,
the segmented streaming oracle and the window oracles.  f32 values agree
to 1e-6; quantized wires and residuals bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diloco as jdiloco
from repro.core import fragments as jfrag
from repro.core import partition as jpartition
from repro.models import api as japi
from repro.configs import get_smoke_config as jget_smoke
from repro_torch.core import diloco, partition, pytree
from repro_torch.core import fragments as tfrag
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree, param_axes
from repro_torch.configs import get_smoke_config
from repro.models.config import DiPaCoConfig as JDiPaCoConfig

W = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_close(mine, theirs, atol=1e-6, exact=False):
    a = pytree.leaves(mine)
    b = jax.tree_util.tree_leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert x.shape == y.shape
        if exact:
            assert x.tobytes() == y.tobytes()
        else:
            np.testing.assert_allclose(x, y, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _setup():
    """Worker-stacked (W, ...) weights around a global copy, the axes and
    the 2x2 mixing matrices, for both packages."""
    cfg = get_smoke_config("dipaco-150m")
    jp, jaxes = japi.init_model(jax.random.PRNGKey(0),
                                jget_smoke("dipaco-150m"))
    rng = np.random.default_rng(0)
    base = _np(jp)
    glob = jax.tree_util.tree_map(
        lambda x: np.repeat(x[None], W, 0).astype(np.float32), base)
    work = jax.tree_util.tree_map(
        lambda g: (g + rng.standard_normal(g.shape) * 0.01)
        .astype(np.float32), glob)
    part = partition.make_partition(DiPaCoConfig(levels=(2, 2)),
                                    cfg.pattern_repeats)
    jpart = jpartition.make_partition(JDiPaCoConfig(levels=(2, 2)),
                                      cfg.pattern_repeats)
    alphas = np.asarray([0.1, 0.2, 0.3, 0.4])
    mixl, mixs = partition.mixing_matrices(part, np.arange(W) % 4, alphas)
    jmixl, jmixs = jpartition.mixing_matrices(jpart, np.arange(W) % 4,
                                              alphas)
    np.testing.assert_array_equal(mixl, jmixl)
    return {"cfg": cfg, "axes": param_axes(cfg), "jaxes": jaxes,
            "glob": glob, "work": work, "mixl": mixl, "mixs": mixs}


def test_leaf_axes_list_and_quorum_match_reference(setup):
    s = setup
    mine = diloco.leaf_axes_list(from_numpy_tree(s["glob"], device="cpu"),
                                 s["axes"])
    assert mine == jdiloco.leaf_axes_list(_j(s["glob"]), s["jaxes"])
    for frac in (1.0, 0.5, 0.3, 0.0):
        for n in (0, 1, 3, 4, 7):
            assert diloco.quorum_size(frac, n) == jdiloco.quorum_size(frac, n)


@pytest.mark.parametrize("k,sync,dtype", [
    (1, None, "fp32"), (3, None, "fp32"), (3, [0, 2], "fp32"),
    (4, [1], "int8"), (2, None, "int4")])
def test_streaming_outer_step_matches_reference(setup, k, sync, dtype):
    s = setup
    tw, tg = (from_numpy_tree(s[n], device="cpu") for n in ("work", "glob"))
    jw, jg = _j(s["work"]), _j(s["glob"])
    tspec, jspec = tfrag.FragmentSpec(tg, k), jfrag.FragmentSpec(jg, k)
    tst = diloco.fragment_state_init(tg, tspec)
    jst = jdiloco.fragment_state_init(jg, jspec)
    for _ in range(2):     # the second step runs on non-zero momentum
        tw, tg, tst = diloco.streaming_outer_step(
            tw, tg, tst, s["axes"], torch.as_tensor(s["mixl"]),
            torch.as_tensor(s["mixs"]), tspec, sync_fragments=sync,
            comm_dtype=dtype)
        jw, jg, jst = jdiloco.streaming_outer_step(
            jw, jg, jst, s["jaxes"], jnp.asarray(s["mixl"]),
            jnp.asarray(s["mixs"]), jspec, sync_fragments=sync,
            comm_dtype=dtype)
        _assert_close(tw, jw)
        _assert_close(tg, jg)
        for a, b in zip(tst, jst):
            assert sorted(a) == sorted(b)
            _assert_close([a[i] for i in sorted(a)],
                          [b[i] for i in sorted(b)])
    if k == 1 and dtype == "fp32":
        # one fragment, all synced, fp32: outer_step, bit for bit
        tw0, tg0 = (from_numpy_tree(s[n], device="cpu")
                    for n in ("work", "glob"))
        ow, og, _ = diloco.outer_step(
            tw0, tg0, diloco.outer_state_init(tg0), s["axes"],
            torch.as_tensor(s["mixl"]), torch.as_tensor(s["mixs"]))
        sw, sg, _ = diloco.streaming_outer_step(
            tw0, tg0, diloco.fragment_state_init(tg0, tspec), s["axes"],
            torch.as_tensor(s["mixl"]), torch.as_tensor(s["mixs"]), tspec)
        for a, b in zip(pytree.leaves(ow), pytree.leaves(sw)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["fp32", "int8", "int4"])
def test_rowwise_quantize_and_fragment_fns_match_reference(setup, dtype):
    s = setup
    rng = np.random.default_rng(1)
    delta = {"a": rng.standard_normal((W, 5, 3)).astype(np.float32),
             "b": rng.standard_normal((W, 7)).astype(np.float32)}
    resid = {k: (v * 0.01).astype(np.float32) for k, v in delta.items()}
    for r in (None, resid):
        tw, tr = diloco.rowwise_quantize_with_feedback(
            jax.tree_util.tree_map(torch.from_numpy, delta),
            None if r is None else jax.tree_util.tree_map(torch.from_numpy,
                                                          r), dtype)
        jw, jr = jdiloco.rowwise_quantize_with_feedback(
            _j(delta), None if r is None else _j(r), dtype)
        _assert_close(tw, jw, exact=True)
        if dtype == "fp32":
            assert tr is None and jr is None
        else:
            _assert_close(tr, jr, exact=True)
    # the fragment delta and apply functions over {leaf_idx: (W, ...)}
    g = {0: delta["a"], 3: delta["b"]}
    w = {i: (x + 0.05).astype(np.float32) for i, x in g.items()}
    tfn, jfn = diloco.make_fragment_delta_fn(dtype), \
        jdiloco.make_fragment_delta_fn(dtype)
    tt = {i: torch.from_numpy(x) for i, x in w.items()}
    tg = {i: torch.from_numpy(x) for i, x in g.items()}
    twire, tres = tfn(tt, tg, None)
    jwire, jres = jfn(_j(w), _j(g), None)
    _assert_close(twire, jwire, exact=True)
    mom = {i: np.full(x.shape, 0.1, np.float32) for i, x in g.items()}
    ta = diloco.make_fragment_apply_fn(lr=0.7, momentum=0.9)(
        twire, {i: torch.from_numpy(x) for i, x in mom.items()}, tg, tt)
    ja = jdiloco.make_fragment_apply_fn(lr=0.7, momentum=0.9)(
        jwire, _j(mom), _j(g), _j(w))
    for a, b in zip(ta, ja):
        _assert_close(a, b)


@pytest.mark.parametrize("k,dtype", [(1, "fp32"), (3, "int8"), (2, "int4")])
def test_segmented_streaming_phase_matches_reference(setup, k, dtype):
    s = setup
    tw, tg = (from_numpy_tree(s[n], device="cpu") for n in ("work", "glob"))
    jw, jg = _j(s["work"]), _j(s["glob"])
    tspec, jspec = tfrag.FragmentSpec(tg, k), jfrag.FragmentSpec(jg, k)

    def tseg(seg, wp):
        return pytree.tree_map(lambda x: x * (1.0 - 0.01 * (seg + 1)), wp)

    def jseg(seg, wp):
        return jax.tree_util.tree_map(
            lambda x: x * (1.0 - 0.01 * (seg + 1)), wp)

    tst, jst = diloco.fragment_state_init(tg, tspec), \
        jdiloco.fragment_state_init(jg, jspec)
    tres, jres = None, None
    for phase in range(2):
        tw, tg, tst, tres = diloco.segmented_streaming_phase(
            tseg, tw, tg, tst, tres, s["axes"], torch.as_tensor(s["mixl"]),
            torch.as_tensor(s["mixs"]), tspec, comm_dtype=dtype)
        jw, jg, jst, jres = jdiloco.segmented_streaming_phase(
            jseg, jw, jg, jst, jres, s["jaxes"], jnp.asarray(s["mixl"]),
            jnp.asarray(s["mixs"]), jspec, comm_dtype=dtype)
        assert sorted(tres) == sorted(jres)
        pairs = [(tw, jw), (tg, jg),
                 ([tres[i] for i in sorted(tres)],
                  [jres[i] for i in sorted(jres)])]
        if dtype == "fp32":
            for a, b in pairs:
                _assert_close(a, b)
            continue
        # the reference jits its fragment delta function, and XLA's fused
        # f32 operations round the scale and the residual differently
        # from its own eager ones (the rowwise test above, eager in both
        # packages, is bit for bit); so does the second phase's input,
        # after the first outer step's f32 sums.  A value on a rounding
        # tie may then land one quantization step away, and the mixing
        # carries it to every worker row of that module (a few elements
        # in a million); every other element agrees to 1e-6
        for a, b in pairs:
            for x, y in zip(pytree.leaves(a), jax.tree_util.tree_leaves(b)):
                d = np.abs(x.numpy() - np.asarray(y))
                assert (d > 1e-6).sum() <= max(16, 1e-4 * d.size)
                assert d.max() <= 1e-2


def test_window_oracles_match_reference(setup):
    s = setup
    rng = np.random.default_rng(2)
    segs = [jax.tree_util.tree_map(
        lambda x: (x[0] + rng.standard_normal(x[0].shape) * 0.1)
        .astype(np.float32), s["work"]) for _ in range(3)]
    # a module's slice: None where the leaf is another module's
    segs = [dict(x, embed={"embedding": None}) for x in segs]
    weights = [0.25, 0.5, 0.125]
    tsegs = [pytree.tree_map(torch.from_numpy, x) for x in segs]
    jsegs = [jax.tree_util.tree_map(jnp.asarray, x) for x in segs]
    for rescale in (True, False):
        _assert_close(diloco.window_outer_gradient(tsegs, weights,
                                                   rescale=rescale),
                      jdiloco.window_outer_gradient(jsegs, weights,
                                                    rescale=rescale))
    tspec, jspec = tfrag.FragmentSpec(tsegs[0], 3), \
        jfrag.FragmentSpec(jsegs[0], 3)
    for f in range(3):
        a = diloco.fragment_window_outer_gradient(tsegs, weights, tspec, f)
        b = jdiloco.fragment_window_outer_gradient(jsegs, weights, jspec, f)
        assert sorted(a) == sorted(b)
        _assert_close([a[i] for i in sorted(a)], [b[i] for i in sorted(b)])
