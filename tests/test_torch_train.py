"""The port's training slice against the JAX package, on the CPU in f32
at smoke size: schedule, AdamW, Nesterov, the data streams, sharding,
the partition and mixing matrices, the DiLoCo outer step, k-means and
the discriminative router, one inner step, and two phases of a 2x2
``make_trainer(backend="vector")`` run, each on the same numpy-seeded
inputs and weights.

The JAX model runs at ``attn_impl="chunked"``; the port at ``"pallas"``,
which on the CPU is the ``FlashAttention`` Function over the plain
kernels, and also at ``"chunked"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import diloco as jdiloco
from repro.core import partition as jpartition
from repro.core.routing import discriminative as jdisc
from repro.core.routing import kmeans as jkmeans
from repro.data import loader as jloader
from repro.data import sharder as jsharder
from repro.launch.steps import make_inner_train_step as jinner_step
from repro.models import api as japi
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro.optim import adamw as jadamw
from repro.optim import nesterov as jnesterov
from repro.optim import schedule as jschedule
from repro_torch.configs import get_smoke_config
from repro_torch.core import diloco, partition
from repro_torch.core.routing import kmeans
from repro_torch.core.routing.discriminative import \
    train_discriminative_router
from repro_torch.data import loader, sharder
from repro_torch.launch.steps import make_inner_train_step
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import (from_numpy_tree, param_axes,
                                       to_numpy_tree, tree_map)
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.optim import nesterov_init, nesterov_update
from repro_torch.training import make_trainer

T_ = torch.from_numpy


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


def _assert_trees_close(mine, theirs, atol, rtol=0.0):
    a, b = _flat(to_numpy_tree(mine)), _flat(_np(theirs))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _random_tree(cfg, seed, *, lead=(), scale=1.0):
    """A numpy tree with the model's keys and shapes (plus leading axes)."""
    shapes = _flat(_np(japi.init_model(jax.random.PRNGKey(0), cfg)[0]))
    rng = np.random.default_rng(seed)
    flat = {k: (rng.standard_normal(lead + v.shape) * scale)
            .astype(np.float32) for k, v in shapes.items()}
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("dipaco-150m").replace(route_prefix_len=8)


def _jcfg(cfg, **kw):
    from repro.configs import get_smoke_config as jget
    return jget("dipaco-150m").replace(
        route_prefix_len=cfg.route_prefix_len, **kw)


# ---------------------------------------------------------------------------
# optimizers and schedule
# ---------------------------------------------------------------------------
def test_cosine_schedule_matches_reference():
    kw = dict(peak_lr=3e-3, warmup=10, total_steps=400)
    for step in [0, 1, 5, 9, 10, 11, 100, 399, 400, 1000]:
        mine = cosine_schedule(step, **kw)
        theirs = jschedule.cosine_schedule(step, **kw)
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine.item(), float(theirs), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, None, 1e-3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(cfg, clip, dtype):
    """Three steps with the reference's b2 = 0.95, weight decay in the
    step and the whole-tree clip; f32 arithmetic, cast back to the
    parameters' dtype (bf16 leaves may differ by one bf16 rounding)."""
    params = _random_tree(cfg, 0)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(dtype),
                                params)
    tp = from_numpy_tree(_np(jp), device="cpu")
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    for i in range(3):
        grads = _random_tree(cfg, 10 + i, scale=0.1)
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        tg = from_numpy_tree(grads, device="cpu")
        jp, js = jadamw.adamw_update(jg, js, jp, lr=jnp.float32(1e-2),
                                     grad_clip=clip)
        tp, ts = adamw_update(tg, ts, tp, lr=torch.tensor(1e-2),
                              grad_clip=clip)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    _assert_trees_close(tp, jp, atol=tol, rtol=tol)
    _assert_trees_close(ts["m"], js["m"], atol=1e-6, rtol=1e-5)
    _assert_trees_close(ts["v"], js["v"], atol=1e-7, rtol=1e-5)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_nesterov_update_matches_reference(cfg):
    params = _random_tree(cfg, 1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = from_numpy_tree(params, device="cpu")
    js, ts = jnesterov.nesterov_init(jp), nesterov_init(tp)
    for i, nest in enumerate((True, True, False)):
        g = _random_tree(cfg, 20 + i, scale=0.01)
        jp, js = jnesterov.nesterov_update(
            jax.tree_util.tree_map(jnp.asarray, g), js, jp, nesterov=nest)
        tp, ts = nesterov_update(from_numpy_tree(g, device="cpu"), ts, tp,
                                 nesterov=nest)
    _assert_trees_close(tp, jp, atol=1e-6, rtol=1e-6)
    _assert_trees_close(ts["momentum"], js["momentum"], atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_loader_and_phase_batches_are_the_reference_streams(tiny_docs):
    docs, _ = tiny_docs
    mine, theirs = loader.ShardLoader(docs, 4, seed=3), \
        jloader.ShardLoader(docs, 4, seed=3)
    np.testing.assert_array_equal(mine.batches(5), theirs.batches(5))
    for shard, phase in [(0, 0), (1, 0), (3, 7)]:
        np.testing.assert_array_equal(
            loader.phase_batches(docs, 4, 3, shard, phase),
            jloader.phase_batches(docs, 4, 3, shard, phase))
    with pytest.raises(ValueError, match="empty shard"):
        loader.ShardLoader(docs[:0], 4)


@pytest.mark.parametrize("topn,holdout", [(1, 0.0), (1, 0.1), (2, 0.05)])
def test_shard_documents_matches_reference(tiny_docs, topn, holdout):
    docs, doms = tiny_docs
    rng = np.random.default_rng(5)
    assign = doms if topn == 1 else np.stack(
        [doms, rng.integers(0, 4, len(doms))], axis=1)
    mine = sharder.shard_documents(docs, assign, 4, holdout_frac=holdout,
                                   seed=2)
    theirs = jsharder.shard_documents(docs, assign, 4, holdout_frac=holdout,
                                      seed=2)
    np.testing.assert_array_equal(mine.sizes, theirs.sizes)
    np.testing.assert_array_equal(mine.alphas(), theirs.alphas())
    np.testing.assert_array_equal(mine.assignments, theirs.assignments)
    for a, b in zip(mine.shards + mine.holdouts,
                    theirs.shards + theirs.holdouts):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# partition, mixing, outer step
# ---------------------------------------------------------------------------
PARTITIONS = [
    dict(levels=(2, 2)),
    dict(levels=(4,), shared_embeddings=False),
    dict(levels=(1,)),
    dict(levels=(2, 3), level_boundaries=(1,)),
    dict(levels=(2, 2), path_specific_levels=(1,)),
    dict(levels=(2, 2), grad_norm_rescale=False),
]


@pytest.mark.parametrize("kw", PARTITIONS)
def test_partition_and_mixing_matrices_equal_reference(kw):
    reps = 4
    mine = partition.make_partition(DiPaCoConfig(**kw), reps)
    theirs = jpartition.make_partition(JDiPaCoConfig(**kw), reps)
    assert mine.levels == theirs.levels
    assert mine.boundaries == theirs.boundaries
    np.testing.assert_array_equal(mine.paths, theirs.paths)
    W = 2 * mine.num_paths
    wp = np.arange(W) % mine.num_paths
    alphas = np.random.default_rng(0).random(W)
    for a in (None, alphas):
        rescale = kw.get("grad_norm_rescale", True)
        m = partition.mixing_matrices(mine, wp, a, grad_norm_rescale=rescale)
        t = jpartition.mixing_matrices(theirs, wp, a,
                                       grad_norm_rescale=rescale)
        for x, y in zip(m, t):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_param_axes_equal_reference(cfg, qk_norm):
    c = cfg.replace(qk_norm=qk_norm)
    theirs = japi.init_model(jax.random.PRNGKey(0), _jcfg(c,
                                                          qk_norm=qk_norm))[1]
    assert param_axes(c) == theirs


def test_outer_step_matches_reference(cfg):
    """One DiLoCo-per-module outer step on worker-stacked trees (2x2
    partition, W = 4, uneven alphas), three times in a row."""
    part = jpartition.make_partition(JDiPaCoConfig(levels=(2, 2)),
                                     cfg.pattern_repeats)
    alphas = np.array([0.1, 0.2, 0.3, 0.4])
    mixl, mixs = jpartition.mixing_matrices(part, np.arange(4), alphas)
    axes = param_axes(cfg)
    g = _random_tree(cfg, 2, lead=(4,))
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = from_numpy_tree(g, device="cpu")
    js, ts = jdiloco.outer_state_init(jg), diloco.outer_state_init(tg)
    for i in range(3):
        w = tree_map(lambda x, i=i: x - 0.01 * np.random.default_rng(30 + i)
                     .standard_normal(x.shape).astype(np.float32), g)
        jw, jg, js = jdiloco.outer_step(
            jax.tree_util.tree_map(jnp.asarray, w), jg, js, axes,
            jnp.asarray(mixl), jnp.asarray(mixs))
        tw, tg, ts = diloco.outer_step(
            from_numpy_tree(w, device="cpu"), tg, ts, axes, T_(mixl),
            T_(mixs))
        g = to_numpy_tree(tg)
        _assert_trees_close(tw, jw, atol=1e-6, rtol=1e-6)
        _assert_trees_close(tg, jg, atol=1e-6, rtol=1e-6)
        _assert_trees_close(ts["momentum"], js["momentum"], atol=1e-6,
                            rtol=1e-5)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def test_kmeans_fit_from_shared_centroids():
    """Lloyd iterations from the reference's own k-means++ seeds: the same
    assignments, centroids and inertia to f32 rounding of the means
    (index_add_ against onehot.T @ z)."""
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((400, 16)) + rng.integers(0, 5, (400, 1)) * 3
         ).astype(np.float32)
    key = jax.random.PRNGKey(1)
    init = np.array(jkmeans._plusplus_init(key, jnp.asarray(z), 5))
    jc, ja, jin = jkmeans.kmeans_fit(key, jnp.asarray(z), 5, iters=10)
    tc, ta, tin = kmeans.kmeans_fit(T_(z), 5, iters=10, init=T_(init))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-5)
    # assignment, product k-means assignment and top-n
    np.testing.assert_array_equal(
        kmeans.kmeans_assign(T_(z), tc)[0].numpy(),
        np.asarray(jkmeans.kmeans_assign(jnp.asarray(z), jc)[0]))
    pair = (tc[:, :8].contiguous(), tc[:, 8:].contiguous())
    np.testing.assert_array_equal(
        kmeans.product_kmeans_assign(T_(z), pair).numpy(),
        np.asarray(jkmeans.product_kmeans_assign(
            jnp.asarray(z), tuple(jnp.asarray(p.numpy()) for p in pair))))
    np.testing.assert_array_equal(
        np.sort(kmeans.topn_assign(T_(z), tc, 2).numpy(), axis=1),
        np.sort(np.asarray(jkmeans.topn_assign(jnp.asarray(z), jc, 2)),
                axis=1))


def test_kmeans_fit_seeds_from_a_torch_generator():
    z = T_(np.random.default_rng(1).standard_normal((200, 8))
           .astype(np.float32))
    runs = [kmeans.kmeans_fit(z, 4, generator=torch.Generator()
                              .manual_seed(7)) for _ in range(2)]
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=0, rtol=0)
    assert sorted(set(runs[0][1].tolist())) == [0, 1, 2, 3]


def test_train_discriminative_router_matches_reference():
    """Full-batch logistic regression + bias calibration from the same
    initial weights: the same predictions, weights to 1e-5."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((256, 12)).astype(np.float32)
    targets = (feats[:, 0] > 0).astype(np.int32) * 2 + (feats[:, 1] > 0)
    key = jax.random.PRNGKey(3)
    w0 = np.array(jax.random.normal(key, (12, 4)) * 0.01)
    theirs = jdisc.train_discriminative_router(key, feats, targets, 4,
                                               steps=200)
    mine = train_discriminative_router(T_(feats), T_(targets), 4, steps=200,
                                       init_w=T_(w0))
    for f in ("w", "b", "mu", "sigma"):
        np.testing.assert_allclose(getattr(mine, f).numpy(),
                                   np.asarray(getattr(theirs, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(mine.assign(T_(feats)).numpy(),
                                  np.asarray(theirs.assign(feats)))


# ---------------------------------------------------------------------------
# inner step, phases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_inner_step_matches_reference(cfg, tiny_base, tiny_docs, impl):
    """One AdamW inner step of W = 2 workers from different weights on
    different batches: the JAX model at "chunked" against the port at
    ``impl``.  The gradients (AdamW's first moment, (1 - b1) g) agree to
    1e-7 absolute and the parameters to 1e-5 after a step of lr 1e-3,
    except where a gradient element is below 1e-6: AdamW's first step is
    lr * g / (|g| + 1e-8), which turns the f32 rounding of such a
    gradient into up to lr of movement; there (under 1% of the
    elements), to lr."""
    base = _np(tiny_base[0])
    W, lr = 2, 1e-3
    noise = _random_tree(cfg, 4, lead=(W,), scale=0.01)
    wp = jax.tree_util.tree_map(lambda b, n: (b[None] + n).astype(b.dtype),
                                base, noise)
    docs, _ = tiny_docs
    batch = docs[:8].reshape(W, 4, -1)
    jwp = jax.tree_util.tree_map(jnp.asarray, wp)
    jnew, jopt, jm = jinner_step(_jcfg(cfg, attn_impl="chunked"))(
        jwp, jax.vmap(jadamw.adamw_init)(jwp),
        {"tokens": jnp.asarray(batch)}, jnp.float32(lr))
    twp = from_numpy_tree(wp, device="cpu")
    topt = tree_map(lambda x: x[None].repeat(W, *([1] * x.ndim)),
                    adamw_init(from_numpy_tree(base, device="cpu")))
    tnew, tstate, tm = make_inner_train_step(cfg.replace(attn_impl=impl))(
        twp, topt, {"tokens": T_(batch)}, torch.tensor(lr))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-6)
    _assert_trees_close(tstate["m"], jopt["m"], atol=1e-7)
    new, jn = _flat(to_numpy_tree(tnew)), _flat(_np(jnew))
    m, jmom = _flat(to_numpy_tree(tstate["m"])), _flat(_np(jopt["m"]))
    tiny = 0
    for k in new:
        g = np.minimum(np.abs(m[k]), np.abs(jmom[k])) / 0.1
        tol = np.where(g < 1e-6, lr, 1e-5)
        tiny += int((g < 1e-6).sum())
        assert (np.abs(new[k] - jn[k]) <= tol).all(), k
    assert tiny <= 1e-2 * sum(x.size for x in new.values())
    # the step updates the stacked weights and moments in place
    assert tnew is twp and tstate is topt


def _trainers(cfg, tiny_base, tiny_docs, impl, dcfg_kw=None, **kw):
    docs, doms = tiny_docs
    dkw = dict(levels=(2, 2), inner_steps=3, **(dcfg_kw or {}))
    jds = jsharder.shard_documents(docs, doms, 4, holdout_frac=0.1)
    tds = sharder.shard_documents(docs, doms, 4, holdout_frac=0.1)
    common = dict(batch_size=4, peak_lr=3e-3, warmup=2, total_steps=6, **kw)
    jt = repro.make_trainer(_jcfg(cfg, attn_impl="chunked"),
                            JDiPaCoConfig(**dkw), jds, backend="vector",
                            key=jax.random.PRNGKey(0),
                            base_params=tiny_base[0], **common)
    tt = make_trainer(cfg.replace(attn_impl=impl), DiPaCoConfig(**dkw), tds,
                      backend="vector", device="cpu",
                      base_params=from_numpy_tree(_np(tiny_base[0]),
                                                  device="cpu"), **common)
    return jt, tt


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_two_phases_of_2x2_trainer_match_reference(cfg, tiny_base, tiny_docs,
                                                   impl):
    """2 phases of tau = 3 of a 2x2 DiPaCo (4 paths, 4 workers): phase
    losses to 1e-5 and every worker's parameters, the module store and
    the outer momentum to 1e-4 after 6 AdamW steps and 2 outer steps."""
    jt, tt = _trainers(cfg, tiny_base, tiny_docs, impl,
                       dcfg_kw=dict(early_stopping=True))
    for _ in range(2):
        jm, tm = jt.run_phase(), tt.run_phase()
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-5)
        np.testing.assert_allclose(tm.per_path_loss, jm.per_path_loss,
                                   rtol=1e-5)
        _assert_trees_close(tt.worker_params, jt.worker_params, atol=1e-4)
        _assert_trees_close(tt.global_params, jt.global_params, atol=1e-4)
        _assert_trees_close(tt.outer_state["momentum"],
                            jt.outer_state["momentum"], atol=1e-4)
        np.testing.assert_allclose(tt.best_holdout, jt.best_holdout,
                                   rtol=1e-5)
    # paths through the same module keep identical copies of it
    for leaf in _flat(to_numpy_tree(tt.worker_params["blocks"])).values():
        np.testing.assert_array_equal(leaf[0, 0], leaf[1, 0])
    val = tiny_docs[0][-32:]
    assign = np.arange(32) % 4
    for best in (False, True):
        np.testing.assert_allclose(
            tt.evaluate_routed(val, assign, best=best)["nll"],
            jt.evaluate_routed(val, assign, best=best)["nll"], rtol=1e-5)
    _assert_trees_close(tt.path_params(3), jt.path_params(3), atol=1e-4)


def test_sync_trainer_matches_reference(cfg, tiny_base, tiny_docs):
    """The fully-synchronous ablation (per-step gradient mixing, no outer
    optimizer): one phase of tau = 3."""
    from repro.core.dipaco import SyncDiPaCoTrainer as JSync
    from repro_torch.core.dipaco import SyncDiPaCoTrainer
    docs, doms = tiny_docs
    kw = dict(batch_size=4, peak_lr=3e-3, warmup=2, total_steps=6)
    jt = JSync(_jcfg(cfg, attn_impl="chunked"), JDiPaCoConfig(levels=(2, 2)),
               jsharder.shard_documents(docs, doms, 4),
               key=jax.random.PRNGKey(0), base_params=tiny_base[0], **kw)
    tt = SyncDiPaCoTrainer(cfg.replace(attn_impl="pallas"),
                           DiPaCoConfig(levels=(2, 2)),
                           sharder.shard_documents(docs, doms, 4),
                           base_params=from_numpy_tree(_np(tiny_base[0]),
                                                       device="cpu"), **kw)
    jm, tm = jt.run_phase(3), tt.run_phase(3)
    np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-5)
    _assert_trees_close(tt.worker_params, jt.worker_params, atol=1e-4)


def test_trainer_surface(cfg, tiny_base, tiny_docs):
    from repro_torch.core.dipaco import (PhaseMetrics, diloco_config,
                                         flat_moe_config)
    m = PhaseMetrics(mean_loss=1.0, extra={"outer_updates": 3})
    assert m["outer_updates"] == 3 and m["mean_loss"] == 1.0
    assert m.get("nope", 7) == 7 and "outer_updates" in m.keys()
    assert flat_moe_config(4) == dataclasses.replace(
        DiPaCoConfig(levels=(4,)), shared_embeddings=False)
    assert diloco_config(4).levels == (1,)
    docs, doms = tiny_docs
    ds = sharder.shard_documents(docs, doms, 4)
    from repro_torch.launch.train import MeshStreamingTrainer
    from repro_torch.training import Trainer
    mesh = make_trainer(cfg, DiPaCoConfig(levels=(2, 2)), ds, backend="mesh",
                        device="cpu")
    assert isinstance(mesh, MeshStreamingTrainer) and isinstance(mesh,
                                                                 Trainer)
    with pytest.raises(ValueError, match="ckpt_root"):    # resumes from one
        make_trainer(cfg, DiPaCoConfig(), ds, backend="mesh", device="cpu",
                     resume=True)
    for backend in ("barrier", "service"):     # they persist to a DB
        with pytest.raises(ValueError, match="ckpt_root"):
            make_trainer(cfg, DiPaCoConfig(), ds, backend=backend,
                         device="cpu")
    with pytest.raises(ValueError):
        make_trainer(cfg, DiPaCoConfig(), ds, backend="nope", device="cpu")
    with pytest.raises(NotImplementedError, match="cannot resume"):
        make_trainer(cfg, DiPaCoConfig(), ds, device="cpu", resume=True)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.train import main
    res = main(["--device", "cpu", "--smoke", "--docs", "128", "--tau", "3",
                "--phases", "2", "--seq", "48"])
    out = capsys.readouterr().out
    assert "[phase 1]" in out and "[done]" in out
    assert all(np.isfinite(res["phase_loss"])) and np.isfinite(res["ppl"])
