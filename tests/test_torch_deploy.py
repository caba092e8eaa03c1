"""The port's deployment plane (``repro_torch.deploy``) and the engines'
hot swap, held to the JAX package's on the CPU from the same weights
(``init_model`` of the reference, crossed with ``from_numpy_tree``): the
manifest JSON and its signature, ``tree_digest`` equal to the reference's
hex digest in f32 and bf16, content-addressed registration, promote and
rollback bit for bit, the pointer refresh across processes, the
publisher's cut per completed phase, restart, quarantine, background
thread and chaos points, bounded caches, the canary's scores against
the JAX ``CanaryGate`` (1e-5), drain and live swaps in the continuous
engine and ``poll_registry`` in the one-shot engine with greedy tokens
equal to the JAX engines' in fp32, and registries written by one package
opened by the other.  Module rows from the outer executors are f32 here:
the reference's ``load_tree`` rejects bf16 rows (ROADMAP queue 3)."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import deploy as jdeploy
from repro.core.module_store import ModuleStore as JStore
from repro.core.partition import make_partition as jmake_partition
from repro.infra import CheckpointDB as JDB
from repro.infra import ShardedOuterExecutors as JExecs
from repro.models import api as japi
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro.serving import ContinuousBatchingEngine as JContinuous
from repro.serving import EngineOptions as JOptions
from repro.serving import PathServingEngine as JOneShot
from repro.serving import Request as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.core import pytree
from repro_torch.core.module_store import ModuleStore
from repro_torch.core.partition import make_partition
from repro_torch.deploy import (SHARED_ID, CanaryGate, CanaryReport,
                                DeploymentRegistry, Manifest, ModuleRef,
                                Publisher, tree_digest)
from repro_torch.infra import CheckpointDB, ShardedOuterExecutors
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree, param_axes
from repro_torch.serving import (ContinuousBatchingEngine, EngineOptions,
                                 PathServingEngine, Request)

LEVELS = (2, 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tcfg(jcfg):
    return get_smoke_config("dipaco-150m").replace(
        route_prefix_len=jcfg.route_prefix_len)


@pytest.fixture()
def plane(tiny_cfg, tiny_base, tmp_path):
    """The port's training-side store, executors and DB plus a registry
    (4 paths, levels (2, 2)) on the CPU, from the reference's weights."""
    cfg = _tcfg(tiny_cfg)
    base = from_numpy_tree(_np(tiny_base[0]), device="cpu")
    dcfg = DiPaCoConfig(levels=LEVELS)
    part = make_partition(dcfg, cfg.pattern_repeats)
    db = CheckpointDB(str(tmp_path / "db"))
    store = ModuleStore(base, param_axes(cfg), part)
    execs = ShardedOuterExecutors(store, part, np.arange(4), ckpt_db=db)
    reg = DeploymentRegistry(cfg, dcfg, str(tmp_path / "deploy"),
                             base_params=base, device="cpu")
    return dict(cfg=cfg, jcfg=tiny_cfg, dcfg=dcfg, base=base,
                jbase=tiny_base[0], db=db, execs=execs, reg=reg,
                tmp=tmp_path)


def _jplane(pl):
    """The same deployment in the JAX package, beside ``pl``."""
    jcfg, jbase = pl["jcfg"], pl["jbase"]
    _, axes = japi.init_model(jax.random.PRNGKey(0), jcfg)
    dcfg = JDiPaCoConfig(levels=LEVELS)
    part = jmake_partition(dcfg, jcfg.pattern_repeats)
    db = JDB(str(pl["tmp"] / "jdb"))
    execs = JExecs(JStore(jbase, axes, part), part, np.arange(4),
                   ckpt_db=db)
    reg = jdeploy.DeploymentRegistry(jcfg, dcfg, str(pl["tmp"] / "jdeploy"),
                                     key=jax.random.PRNGKey(0),
                                     base_params=jbase)
    return dict(cfg=jcfg, dcfg=dcfg, base=jbase, db=db, execs=execs,
                reg=reg)


def _outer_phase(pl, phase, scale=0.01):
    """One full outer phase: every worker reports, every executor
    applies, one module row per executor lands in the DB."""
    for w in range(4):
        pl["execs"].accumulate(w, pytree.tree_map(
            lambda x: torch.full(x.shape, scale * (w + 1)), pl["base"]),
            phase=phase)


def _jouter_phase(jp, phase, scale=0.01):
    for w in range(4):
        jp["execs"].accumulate(w, jax.tree_util.tree_map(
            lambda x: jnp.full(x.shape, scale * (w + 1), jnp.float32),
            jp["base"]), phase=phase)


def _latest_module_rows(db):
    latest = {}
    for r in db.rows(kind="module"):
        latest[(r.level, r.expert)] = r
    return latest


def _leaves(paths):
    return [[np.asarray(x) for x in pytree.leaves(p)] for p in paths]


def _assert_paths_equal(a, b):
    for pa, pb in zip(_leaves(a), _leaves(b)):
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(x, y)


def _assert_paths_match_reference(paths, jpaths, atol=0.0):
    """The port's path trees against the JAX package's, leaf by leaf in
    ``jax.tree_util`` order."""
    assert len(paths) == len(jpaths)
    for p, jp in zip(paths, jpaths):
        mine = [x.numpy() for x in pytree.leaves(p)]
        theirs = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
        assert len(mine) == len(theirs)
        for x, y in zip(mine, theirs):
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def _bumped_rows(pl, jp, factor=1.01):
    """Module rows holding the base times ``factor`` (the same f32 values
    in both packages), written to each package's DB: two registries then
    hold bit-identical versions."""
    jbumped = jax.tree_util.tree_map(lambda x: np.asarray(x) * factor,
                                     jp["base"])
    _, axes = japi.init_model(jax.random.PRNGKey(0), jp["cfg"])
    jstore = JStore(jbumped, axes, jmake_partition(jp["dcfg"],
                                                   jp["cfg"]
                                                   .pattern_repeats))
    store = ModuleStore(from_numpy_tree(jbumped, device="cpu"),
                        param_axes(pl["cfg"]), pl["reg"].partition)
    rows, jrows = {}, {}
    for mid in pl["reg"].module_ids:
        tree = store.shared if mid == SHARED_ID \
            else store.module_params(*mid)
        jtree = jstore.shared if mid == SHARED_ID \
            else jstore.module_params(*mid)
        rows[mid] = pl["db"].write({"params": tree}, path_id=0, phase=1,
                                   step=1, kind="module", level=mid[0],
                                   expert=mid[1])
        jrows[mid] = jp["db"].write({"params": jtree}, path_id=0, phase=1,
                                    step=1, kind="module", level=mid[0],
                                    expert=mid[1])
    return rows, jrows


def _prompt(cfg, n=16, seed=11):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


# ---------------------------------------------------------------------
# manifest and digests
# ---------------------------------------------------------------------

def test_manifest_roundtrip_and_signature():
    refs = (ModuleRef(level=0, expert=0, digest="aa", file="x.npz",
                      phase=3, step=7),
            ModuleRef(level=-1, expert=-1, digest="bb"))
    m = Manifest(version=2, refs=refs, parent=1, note="test",
                 created_at=12.5, cut_phase=3)
    back = Manifest.from_json(m.to_json())
    assert back == m
    assert back.signature == m.signature == ("bb", "aa")
    with pytest.raises(ValueError, match="duplicate"):
        Manifest(version=3, refs=(refs[0], refs[0]))
    # the reference's JSON, field for field and in the same order
    jm = jdeploy.Manifest(
        version=2, parent=1, note="test", created_at=12.5, cut_phase=3,
        refs=tuple(jdeploy.ModuleRef(**vars(r)) for r in refs))
    assert m.to_json() == jm.to_json()
    assert jdeploy.Manifest.from_json(m.to_json()).signature == m.signature


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_digest_matches_reference(tiny_cfg, dtype):
    jcfg = tiny_cfg.replace(dtype=dtype)
    jbase, axes = japi.init_model(jax.random.PRNGKey(3), jcfg)
    base = from_numpy_tree(_np(jbase), device="cpu")
    assert tree_digest(base) == jdeploy.tree_digest(jbase)
    # the module trees of a store, ``None`` where a leaf is elsewhere
    jpart = jmake_partition(JDiPaCoConfig(levels=LEVELS),
                            jcfg.pattern_repeats)
    jstore = JStore(jbase, axes, jpart)
    store = ModuleStore(base, param_axes(_tcfg(jcfg).replace(dtype=dtype)),
                        make_partition(DiPaCoConfig(levels=LEVELS),
                                       jcfg.pattern_repeats))
    for level, expert in ((0, 0), (1, 1)):
        assert tree_digest(store.module_params(level, expert)) == \
            jdeploy.tree_digest(jstore.module_params(level, expert))
    assert tree_digest(store.shared) == jdeploy.tree_digest(jstore.shared)
    bumped = pytree.tree_map(lambda x: x * 2, base)
    assert tree_digest(bumped) != tree_digest(base)


# ---------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------

def test_registry_register_cas_dedup(plane):
    reg, db = plane["reg"], plane["db"]
    _outer_phase(plane, 0)
    rows = _latest_module_rows(db)
    assert set(rows) == set(reg.module_ids)
    m1 = reg.register(rows, note="phase 0")
    assert m1.version == 1
    for ref in m1.refs:
        assert ref.file is not None and ref.file.startswith(reg.root)
        assert os.path.exists(ref.file)
    assert reg.register(rows).version == 1    # the same composition
    m_base = reg.register(note="base")
    assert m_base.version == 2
    assert all(r.file is None for r in m_base.refs)
    assert m_base.signature != m1.signature
    # the base refs carry the reference registry's digests
    jreg = _jplane(plane)["reg"]
    assert m_base.signature == jreg.register(note="base").signature


def test_registry_promote_rollback_bit_exact(plane):
    reg, db = plane["reg"], plane["db"]
    jp = _jplane(plane)
    jreg = jp["reg"]
    for r in (reg, jreg):
        r.promote(r.register().version)
    base_paths = reg.serving_paths()
    _assert_paths_match_reference(base_paths, jreg.serving_paths())
    _outer_phase(plane, 0)
    _jouter_phase(jp, 0)
    m1 = reg.register(_latest_module_rows(db))
    reg.promote(m1.version)
    jreg.promote(jreg.register(_latest_module_rows(jp["db"])).version)
    v1_paths = reg.serving_paths()
    # the outer step in the port and in the reference: f32 order only
    _assert_paths_match_reference(v1_paths, jreg.serving_paths(),
                                  atol=1e-6)
    _outer_phase(plane, 1, scale=-0.005)
    m2 = reg.register(_latest_module_rows(db))
    reg.promote(m2.version)
    assert reg.serving_version == m2.version
    assert any(not np.array_equal(x, y) for x, y in
               zip(_leaves(v1_paths)[0], _leaves(reg.serving_paths())[0]))
    assert reg.rollback() == m1.version
    _assert_paths_equal(reg.serving_paths(), v1_paths)
    assert reg.serving_paths() is v1_paths       # the memoized tensors
    assert reg.rollback() == 1
    _assert_paths_equal(reg.serving_paths(), base_paths)
    assert reg.promotion_history == []
    with pytest.raises(RuntimeError, match="roll back"):
        reg.rollback()
    with pytest.raises(KeyError):
        reg.promote(99)


def test_registry_reopen_across_process(plane):
    """A fresh registry on the same root sees the manifests and the
    pointer and materializes bit for bit, after the DB dropped the row
    files (the registry holds its own copies)."""
    reg, db = plane["reg"], plane["db"]
    reg.register()
    _outer_phase(plane, 0)
    m1 = reg.register(_latest_module_rows(db))
    reg.promote(1)
    reg.promote(m1.version)
    v1_paths = reg.serving_paths()
    for r in db.rows(kind="module"):
        os.remove(r.file)
    reg2 = DeploymentRegistry(plane["cfg"], plane["dcfg"], reg.root,
                              base_params=plane["base"], device="cpu")
    assert reg2.versions == reg.versions
    assert reg2.serving_version == m1.version
    _assert_paths_equal(reg2.serving_paths(), v1_paths)
    reg2.rollback()
    assert reg2.serving_version == 1


def test_cross_process_pointer_refresh(plane):
    """A registry opened by another process sees promotes and rollbacks
    made after it opened, and manifests minted since; an engine on it
    swaps."""
    cfg, reg, db = plane["cfg"], plane["reg"], plane["db"]
    m1 = reg.register()
    reg.promote(m1.version)
    reader = DeploymentRegistry(cfg, plane["dcfg"], reg.root,
                                base_params=plane["base"], device="cpu")
    eng = ContinuousBatchingEngine(cfg, options=EngineOptions(
        registry=reader, cache_len=48, slots_per_path=2))
    assert eng.version == m1.version
    _outer_phase(plane, 0)
    m2 = reg.register(_latest_module_rows(db))
    reg.promote(m2.version)
    fins = eng.serve_trace([Request(rid=0, prompt=_prompt(cfg, seed=71),
                                    max_new=4)])
    assert eng.version == m2.version and fins[0].version == m2.version
    _assert_paths_equal(eng.paths, reg.materialize(m2.version))
    reg.rollback()
    assert reader.serving_version == m1.version


def test_registry_caches_stay_bounded(plane):
    reg, db = plane["reg"], plane["db"]
    reg.promote(reg.register().version)
    for ph in range(5):
        _outer_phase(plane, ph, scale=1e-3 * (ph + 1))
        reg.promote(reg.register(_latest_module_rows(db)).version)
        reg.serving_paths()
    assert len(reg._assembled) <= reg.max_cached_versions
    live = set(reg._base_digest.values())
    for m in reg._manifests.values():
        if m.signature in reg._assembled:
            live.update(r.digest for r in m.refs)
    assert set(reg._payload_cache) <= live
    # an evicted version still materializes (reloaded from the store)
    _assert_paths_equal(reg.materialize(2), reg.materialize(2))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_registry_readable_across_packages(plane, writer):
    """A registry written by one package opens in the other: the same
    versions, serving version, history and signatures, and the same
    materialized parameters bit for bit (f32 rows: a K=1 row of the
    outer executors, params and momentum, and a params-only row)."""
    jp = _jplane(plane)
    if writer == "jax":
        w, wdb, phase = jp["reg"], jp["db"], _jouter_phase
        wpl = jp
    else:
        w, wdb, phase = plane["reg"], plane["db"], _outer_phase
        wpl = plane
    w.promote(w.register(note="base").version)
    phase(wpl, 0)
    w.promote(w.register(_latest_module_rows(wdb), cut_phase=0).version)
    rows, jrows = _bumped_rows(plane, jp)
    v3 = w.register(jrows if writer == "jax" else rows, note="bumped")
    w.promote(v3.version)
    w.rollback()
    if writer == "jax":
        r = DeploymentRegistry(plane["cfg"], plane["dcfg"], w.root,
                               base_params=plane["base"], device="cpu")
    else:
        r = jdeploy.DeploymentRegistry(plane["jcfg"], jp["dcfg"], w.root,
                                       key=jax.random.PRNGKey(0),
                                       base_params=jp["base"])
    assert r.versions == w.versions == [1, 2, 3]
    assert r.serving_version == w.serving_version == 2
    assert r.promotion_history == w.promotion_history == [1]
    for v in r.versions:
        assert r.manifest(v).signature == w.manifest(v).signature
        assert r.manifest(v).to_json() == w.manifest(v).to_json()
        mine, theirs = ((r.materialize(v), w.materialize(v))
                        if writer == "jax"
                        else (w.materialize(v), r.materialize(v)))
        _assert_paths_match_reference(mine, theirs)
    assert r.rollback() == 1
    assert w.serving_version == 1            # one pointer on disk


# ---------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------

def test_publisher_cuts_per_completed_outer_phase(plane):
    reg, db, execs, base = (plane["reg"], plane["db"], plane["execs"],
                            plane["base"])
    pub = Publisher(db, reg)
    assert pub.poll() is None                  # no rows yet
    pub.bootstrap()
    assert reg.serving_version == 1

    def delta(v):
        return pytree.tree_map(lambda x: torch.full(x.shape, v), base)

    # partial phase: module (0, 0) applies (workers 0 + 1) but the
    # shared executor waits for workers 2 and 3
    execs.accumulate(0, delta(0.01), phase=0)
    execs.accumulate(1, delta(0.02), phase=0)
    assert pub.completed_phase() == -1
    assert pub.poll() is None
    execs.accumulate(2, delta(0.03), phase=0)
    execs.accumulate(3, delta(0.04), phase=0)
    assert pub.completed_phase() == 0
    m = pub.poll()
    assert m is not None and m.version == 2 and m.cut_phase == 0
    assert pub.poll() is None                  # same phase: no re-cut
    _outer_phase(plane, 1, scale=-0.005)
    assert pub.poll().version == 3
    pub.close()


def test_publisher_promotes_and_listener_wakes(plane):
    reg, db = plane["reg"], plane["db"]
    pub = Publisher(db, reg)
    pub.bootstrap()
    assert not pub._event.is_set()
    _outer_phase(plane, 0)                     # module rows fire listener
    assert pub._event.is_set()
    out = pub.publish_cycle()
    assert out["promoted"] == 2 and reg.serving_version == 2
    assert pub.published == 1
    pub.close()
    pub._event.clear()
    db.write({"a": torch.ones(2)}, path_id=-1, phase=9, step=9,
             kind="module", level=0, expert=0)
    assert not pub._event.is_set()             # the listener is detached


def test_publisher_restart_does_not_rechurn(plane):
    reg, db = plane["reg"], plane["db"]
    pub = Publisher(db, reg)
    pub.bootstrap()
    _outer_phase(plane, 0)
    assert pub.publish_cycle()["promoted"] == 2
    pub.close()
    for _ in range(2):                       # two restarts in a row
        reg2 = DeploymentRegistry(plane["cfg"], plane["dcfg"], reg.root,
                                  base_params=plane["base"], device="cpu")
        pub2 = Publisher(db, reg2)
        assert pub2.bootstrap().version == 1     # dedupe, no churn
        assert reg2.versions == [1, 2]
        assert reg2.serving_version == 2
        out = pub2.publish_cycle()               # nothing new to do
        assert out["cut"] is None and out["promoted"] is None
        pub2.close()


def test_publisher_thread_survives_cycle_errors(plane):
    reg, db = plane["reg"], plane["db"]

    class BrokenGate:
        def evaluate(self, cand, serv):
            raise RuntimeError("scoring blew up")

    pub = Publisher(db, reg, gate=BrokenGate())
    pub.bootstrap()
    pub.start(period=0.02)
    try:
        _outer_phase(plane, 0)
        deadline = time.time() + 10.0
        while pub.cycle_errors == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert pub.cycle_errors >= 1
        assert isinstance(pub.last_error, RuntimeError)
        assert pub._thread.is_alive()
        pub.gate = None
        pub._event.set()
        while reg.serving_version == 1 and time.time() < deadline:
            time.sleep(0.02)
        assert reg.serving_version == 2
    finally:
        pub.close()


def test_canary_scores_match_reference(plane):
    """The port's gate and the JAX gate score the same versions (the
    base and the bumped weights) on the same shadow trace: NLL ratio and
    greedy agreement within 1e-5; a healthy candidate is promoted."""
    reg = plane["reg"]
    jp = _jplane(plane)
    rows, jrows = _bumped_rows(plane, jp)
    shadow = np.random.default_rng(7).integers(
        0, plane["cfg"].vocab_size, (6, 24)).astype(np.int32)
    gate = CanaryGate(plane["cfg"], shadow, ppl_ratio_tol=1.5,
                      min_agreement=0.0)
    jgate = jdeploy.CanaryGate(plane["jcfg"], shadow, ppl_ratio_tol=1.5,
                               min_agreement=0.0)
    v1, v2 = reg.register(), reg.register(rows)
    jv1, jv2 = jp["reg"].register(), jp["reg"].register(jrows)
    rep = gate.evaluate(reg.materialize(v2.version),
                        reg.materialize(v1.version))
    jrep = jgate.evaluate(jp["reg"].materialize(jv2.version),
                          jp["reg"].materialize(jv1.version))
    for a, b in ((rep.ppl_candidate, jrep.ppl_candidate),
                 (rep.ppl_serving, jrep.ppl_serving)):
        assert abs(np.log(a) - np.log(b)) < 1e-5, (a, b)
    assert abs(rep.agreement - jrep.agreement) < 1e-5
    assert 0.0 < rep.agreement < 1.0 and rep.passed == jrep.passed
    # memoized by the identity of the path list
    paths = reg.materialize(v1.version)
    assert gate._score_cached(paths) is gate._score_cached(paths)
    with pytest.raises(ValueError, match="shadow"):
        CanaryGate(plane["cfg"], np.zeros(4, np.int32))


def test_canary_gate_blocks_regression_and_quarantines(plane):
    reg, db, execs = plane["reg"], plane["db"], plane["execs"]
    shadow = np.random.default_rng(7).integers(
        0, plane["cfg"].vocab_size, (6, 24)).astype(np.int32)
    gate = CanaryGate(plane["cfg"], shadow, ppl_ratio_tol=1.5,
                      min_agreement=0.0)
    pub = Publisher(db, reg, gate=gate)
    pub.bootstrap()
    _outer_phase(plane, 0, scale=1e-4)         # small, healthy update
    out = pub.publish_cycle()
    assert out["promoted"] == 2 and out["report"].passed
    assert out["report"].agreement > 0.5
    # a poisoned phase 1: every module row carries huge noise
    gen = torch.Generator().manual_seed(0)
    for (level, expert), ex in execs._all().items():
        params = ex._params()
        noise = pytree.tree_map(
            lambda x: 10.0 * torch.randn(x.shape, generator=gen), params)
        db.write({"params": noise, "momentum": {"momentum": pytree.tree_map(
            torch.zeros_like, noise)}}, path_id=-1, phase=1, step=2,
            kind="module", level=level, expert=expert,
            extra={"updates": 2})
    out = pub.publish_cycle()
    assert out["rejected"] == 3 and out["promoted"] is None
    assert not out["report"].passed
    assert "regression" in out["report"].reason or \
        "finite" in out["report"].reason
    assert reg.serving_version == 2
    out = pub.publish_cycle()                  # quarantined for good
    assert out["promoted"] is None
    pub.close()


def test_auto_rollback_on_bake_regression(plane):
    reg, db = plane["reg"], plane["db"]

    class FailBake:
        def evaluate(self, cand, serv):
            return CanaryReport(9.9, 1.0, 0.0, False, "bake regression")

    pub = Publisher(db, reg, bake_gate=FailBake())
    pub.bootstrap()
    base_paths = reg.serving_paths()
    _outer_phase(plane, 0)
    out = pub.publish_cycle()
    assert out["cut"] == 2 and out["rolled_back"] == 2
    assert out["promoted"] is None and pub.rollbacks == 1
    assert reg.serving_version == 1
    _assert_paths_equal(reg.serving_paths(), base_paths)
    pub.close()


@pytest.mark.parametrize("point", ["promote:pre_pointer",
                                   "pointer:pre_replace"])
def test_chaos_publisher_killed_mid_promote(plane, point):
    """The publisher dies mid-promote: the pointer never dangles, a fresh
    process agrees, and the retried cycle promotes the same candidate."""
    reg, db = plane["reg"], plane["db"]
    pub = Publisher(db, reg)
    pub.bootstrap()
    v1_paths = reg.serving_paths()
    _outer_phase(plane, 0)

    def crash(p):
        if p == point:
            raise RuntimeError(f"killed at {p}")

    reg.fault_injector = crash
    with pytest.raises(RuntimeError, match="killed at"):
        pub.publish_cycle()
    assert reg.serving_version == 1
    with open(reg._ptr_path()) as f:
        ptr = json.load(f)
    assert ptr["serving"] == 1
    assert os.path.exists(reg._manifest_path(ptr["serving"]))
    _assert_paths_equal(reg.serving_paths(), v1_paths)
    reg2 = DeploymentRegistry(plane["cfg"], plane["dcfg"], reg.root,
                              base_params=plane["base"], device="cpu")
    assert reg2.serving_version == 1
    reg.fault_injector = None
    out = pub.publish_cycle()
    assert out["cut"] == 2 and out["promoted"] == 2
    assert reg.versions == [1, 2] and reg.serving_version == 2
    assert reg.rollback() == 1
    _assert_paths_equal(reg.serving_paths(), v1_paths)
    pub.close()


def test_publisher_restart_recovers_unpromoted_cut(plane):
    reg, db = plane["reg"], plane["db"]
    pub = Publisher(db, reg)
    pub.bootstrap()
    _outer_phase(plane, 0)
    assert pub.poll().version == 2             # cut, never promoted
    pub.close()
    reg2 = DeploymentRegistry(plane["cfg"], plane["dcfg"], reg.root,
                              base_params=plane["base"], device="cpu")
    pub2 = Publisher(db, reg2)
    out = pub2.publish_cycle()
    assert out["cut"] == 2 and out["promoted"] == 2
    assert reg2.versions == [1, 2] and reg2.serving_version == 2
    pub2.close()


def test_quarantine_survives_publisher_restart(plane):
    reg, db = plane["reg"], plane["db"]

    class RejectAll:
        def evaluate(self, cand, serv):
            return CanaryReport(9.9, 1.0, 0.0, False, "regression")

    pub = Publisher(db, reg, gate=RejectAll())
    pub.bootstrap()
    _outer_phase(plane, 0)
    out = pub.publish_cycle()
    assert out["rejected"] == 2 and reg.serving_version == 1
    pub.close()
    pub2 = Publisher(db, reg, gate=RejectAll())
    assert pub2._quarantined                   # reloaded from disk
    out = pub2.publish_cycle()
    assert out["promoted"] is None and out["rejected"] is None
    assert reg.serving_version == 1 and reg.versions == [1, 2]
    pub2.close()


def test_chaos_background_publisher_survives_promote_crash(plane):
    reg, db = plane["reg"], plane["db"]
    pub = Publisher(db, reg)
    pub.bootstrap()

    def crash(p):
        if p == "pointer:pre_replace":
            raise RuntimeError("killed mid-promote")

    reg.fault_injector = crash
    pub.start(period=0.02)
    try:
        _outer_phase(plane, 0)
        deadline = time.time() + 10.0
        while pub.cycle_errors == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert pub.cycle_errors >= 1 and pub._thread.is_alive()
        assert reg.serving_version == 1
        reg.fault_injector = None
        pub._event.set()
        while reg.serving_version == 1 and time.time() < deadline:
            time.sleep(0.02)
        assert reg.serving_version == 2 and reg.versions == [1, 2]
    finally:
        pub.close()


# ---------------------------------------------------------------------
# the engines' hot swap, against the JAX engines
# ---------------------------------------------------------------------

def _two_versions(plane):
    """v1 = base (serving), v2 = the base times 1.5 (registered; far
    enough from v1 to change greedy tokens), in the port's registry and
    the reference's, bit-identical."""
    jp = _jplane(plane)
    rows, jrows = _bumped_rows(plane, jp, factor=1.5)
    out = []
    for reg, rr in ((plane["reg"], rows), (jp["reg"], jrows)):
        m1 = reg.register()
        reg.promote(m1.version)
        out.append((reg, m1.version, reg.register(rr).version))
    return out


def _drain_run(make, reg, req, v2, pa, pb):
    """The drain script of the reference's test: A admitted on v1, the
    promote lands mid-flight, B waits for the drain."""
    eng = make()
    eng.submit(req(rid=0, prompt=pa, max_new=8))
    fins = eng.step()
    reg.promote(v2)
    eng.submit(req(rid=1, prompt=pb, max_new=8))
    paused = 0
    while not fins:
        fins = eng.step()
        if eng.in_flight:
            assert 1 not in eng.in_flight      # admissions pause
            paused += 1
    fins_b = []
    while not fins_b:
        fins_b = eng.step()
    return eng, fins[0], fins_b[0], paused


def test_engine_hot_swap_drain_matches_reference(plane):
    """Drain: A finishes on v1, B is admitted after the swap on v2; both
    equal the JAX engine's tokens, B equals a fresh engine's on v2."""
    (reg, v1, v2), (jreg, jv1, jv2) = _two_versions(plane)
    cfg, jcfg = plane["cfg"], plane["jcfg"]
    pa, pb = _prompt(cfg, seed=21), _prompt(cfg, seed=22)
    opts = dict(cache_len=48, slots_per_path=2, swap_policy="drain")
    eng, fa, fb, paused = _drain_run(
        lambda: ContinuousBatchingEngine(cfg, options=EngineOptions(
            registry=reg, **opts)), reg, Request, v2, pa, pb)
    jeng, jfa, jfb, jpaused = _drain_run(
        lambda: JContinuous(jcfg, options=JOptions(registry=jreg, **opts)),
        jreg, JRequest, jv2, pa, pb)
    assert paused == jpaused > 0
    assert (fa.version, fb.version) == (v1, v2)
    assert not fa.swapped_midstream and not fb.swapped_midstream
    assert eng.version == v2 and eng.swaps == 1
    assert eng.last_swap_tick == jeng.last_swap_tick > 0
    np.testing.assert_array_equal(fa.tokens, jfa.tokens)
    np.testing.assert_array_equal(fb.tokens, jfb.tokens)
    assert eng.scheduler.stats.starved_by_path == \
        jeng.scheduler.stats.starved_by_path
    fresh = ContinuousBatchingEngine(cfg, options=EngineOptions(
        registry=reg, cache_len=48, slots_per_path=2))
    ref = fresh.serve_trace([Request(rid=1, prompt=pb, max_new=8)])
    np.testing.assert_array_equal(fb.tokens, ref[0].tokens)
    # a rollback installs v1 again: the engine's paths are v1's bits
    reg.rollback()
    again = eng.serve_trace([Request(rid=2, prompt=pa, max_new=8)])
    assert eng.version == v1 and again[0].version == v1
    _assert_paths_equal(eng.paths, reg.materialize(v1))
    np.testing.assert_array_equal(again[0].tokens, fa.tokens)


def test_engine_hot_swap_live_matches_reference(plane):
    """Live: the swap installs at once, A is re-prefilled on v2 and
    flagged, B is admitted without a pause; tokens equal the JAX
    engine's, and A's differ from an uninterrupted v1 run."""
    (reg, v1, v2), (jreg, jv1, jv2) = _two_versions(plane)
    cfg, jcfg = plane["cfg"], plane["jcfg"]
    pa, pb = _prompt(cfg, seed=31), _prompt(cfg, seed=32)
    opts = dict(cache_len=48, slots_per_path=2, swap_policy="live",
                prefix_cache=4)
    outs = []
    for make, r, req, ver in (
            (lambda: ContinuousBatchingEngine(cfg, options=EngineOptions(
                registry=reg, **opts)), reg, Request, v2),
            (lambda: JContinuous(jcfg, options=JOptions(registry=jreg,
                                                        **opts)),
             jreg, JRequest, jv2)):
        eng = make()
        eng.submit(req(rid=0, prompt=pa, max_new=8))
        eng.step()
        eng.step()
        r.promote(ver)
        eng.submit(req(rid=1, prompt=pb, max_new=8))
        assert not eng.step()                  # installs v2 + admits B
        assert eng.version == ver and 1 in eng.in_flight
        assert len(eng.prefix_cache) == 1      # B's row, under v2
        out = {}
        while len(out) < 2:
            for f in eng.step():
                out[f.rid] = f
        outs.append(out)
    out, jout = outs
    assert out[0].swapped_midstream and out[0].version == v2
    assert not out[1].swapped_midstream and out[1].version == v2
    for rid in (0, 1):
        np.testing.assert_array_equal(out[rid].tokens, jout[rid].tokens)
    reg.rollback()
    fresh1 = ContinuousBatchingEngine(cfg, options=EngineOptions(
        registry=reg, cache_len=48, slots_per_path=2))
    ref1 = fresh1.serve_trace([Request(rid=0, prompt=pa, max_new=8)])
    assert not np.array_equal(out[0].tokens, ref1[0].tokens)


def test_oneshot_engine_polls_registry(plane):
    (reg, v1, v2), (jreg, jv1, jv2) = _two_versions(plane)
    cfg, jcfg = plane["cfg"], plane["jcfg"]
    prompts = _prompt(cfg, seed=41)[None]
    eng = PathServingEngine(cfg, options=EngineOptions(registry=reg,
                                                       cache_len=48))
    jeng = JOneShot(jcfg, options=JOptions(registry=jreg, cache_len=48))
    r1, jr1 = eng.generate(prompts, max_new=6), jeng.generate(prompts, 6)
    assert eng.version == v1 and not eng.poll_registry()
    reg.promote(v2)
    jreg.promote(jv2)
    r2, jr2 = eng.generate(prompts, max_new=6), jeng.generate(prompts, 6)
    assert eng.version == v2
    np.testing.assert_array_equal(r1.tokens, jr1.tokens)
    np.testing.assert_array_equal(r2.tokens, jr2.tokens)
    fresh = PathServingEngine(cfg, options=EngineOptions(registry=reg,
                                                         cache_len=48))
    np.testing.assert_array_equal(r2.tokens,
                                  fresh.generate(prompts, 6).tokens)
    assert not np.array_equal(r1.tokens, r2.tokens)


def test_engine_constructor_errors(plane):
    cfg, reg = plane["cfg"], plane["reg"]
    with pytest.raises(ValueError, match="not both"):
        ContinuousBatchingEngine(cfg, [plane["base"]],
                                 options=EngineOptions(registry=reg))
    with pytest.raises(ValueError, match="swap_policy"):
        EngineOptions(swap_policy="x")
    with pytest.raises(ValueError, match="required"):
        ContinuousBatchingEngine(cfg)
    with pytest.raises(ValueError, match="required"):
        PathServingEngine(cfg)
    with pytest.raises(RuntimeError, match="promote"):   # none promoted
        ContinuousBatchingEngine(cfg, options=EngineOptions(registry=reg))
    if not torch.cuda.is_available():
        # the registry materializes on the card unless told otherwise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeploymentRegistry(cfg, plane["dcfg"], str(plane["tmp"] / "c"),
                               base_params=plane["base"])
