"""The port's serving fleet (``repro_torch.serving.ServingFleet``) held to
the JAX package's on the CPU: the rendezvous rankings, autoscale fan-out
and decay, the in-process fleet's greedy tokens and spread against the
JAX fleet's on the same weights and trace, one promote swapping every
member, the ``"process"`` backend end to end (spawned children on
``device="cpu"``), a member that fails failing the fleet, and the
launcher's ``--deploy-root`` / ``--fleet`` options."""
import jax
import numpy as np
import pytest

from repro.deploy import DeploymentRegistry as JRegistry
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro.serving import EngineOptions as JOptions
from repro.serving import Request as JRequest
from repro.serving import ServingFleet as JFleet
from repro_torch.configs import get_smoke_config
from repro_torch.core import pytree
from repro_torch.deploy import SHARED_ID, DeploymentRegistry
from repro_torch.infra import CheckpointDB
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.serving import (PRIO_HIGH, PRIO_PREEMPTIBLE, PRIO_STANDARD,
                                 ContinuousBatchingEngine, EngineOptions,
                                 Request, ServingFleet, poisson_trace)

LEVELS = (2, 2)


@pytest.fixture()
def fleet_plane(tiny_cfg, tiny_base, tmp_path):
    """A promoted 4-path deployment (levels (2, 2)) in the port, from the
    reference's weights, and the same deployment in the JAX package."""
    cfg = get_smoke_config("dipaco-150m").replace(
        route_prefix_len=tiny_cfg.route_prefix_len)
    nbase = jax.tree_util.tree_map(np.asarray, tiny_base[0])
    base = from_numpy_tree(nbase, device="cpu")
    reg = DeploymentRegistry(cfg, DiPaCoConfig(levels=LEVELS),
                             str(tmp_path / "deploy"), base_params=base,
                             device="cpu")
    jreg = JRegistry(tiny_cfg, JDiPaCoConfig(levels=LEVELS),
                     str(tmp_path / "jdeploy"), key=jax.random.PRNGKey(0),
                     base_params=tiny_base[0])
    for r in (reg, jreg):
        r.promote(r.register(note="v1").version)
    return dict(cfg=cfg, jcfg=tiny_cfg, base=base, reg=reg, jreg=jreg,
                tmp=tmp_path)


def _mint_v2(reg, db_root):
    """Register a second version: every module at 1.01 times its
    materialized payload (f32 rows)."""
    db = CheckpointDB(str(db_root))
    v1 = reg.manifest(reg.serving_version)
    rows = {}
    for ref in v1.refs:
        tree = reg._base[ref.module_id]
        rows[ref.module_id] = db.write(
            {"params": pytree.tree_map(lambda x: x * 1.01, tree)},
            path_id=0, phase=1, step=1, kind="module", level=ref.level,
            expert=ref.expert)
    assert set(rows) == set(reg.module_ids) and SHARED_ID in rows
    return reg.register(rows, note="v2")


def _trace(cfg, req=Request, n=8, seed=4, max_new=4):
    trace = poisson_trace(n, rate=200.0, prompt_lens=(12, 16),
                          max_new=max_new, vocab_size=cfg.vocab_size,
                          seed=seed,
                          priorities=((PRIO_HIGH, PRIO_STANDARD,
                                       PRIO_PREEMPTIBLE),
                                      (0.25, 0.5, 0.25)))
    return [req(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                arrival=r.arrival, priority=r.priority) for r in trace]


def test_fleet_requires_registry(tiny_cfg):
    with pytest.raises(ValueError, match="registry"):
        ServingFleet(tiny_cfg, size=2, options=EngineOptions())
    with pytest.raises(ValueError, match="size"):
        ServingFleet(tiny_cfg, size=0, options=EngineOptions())


@pytest.mark.parametrize("size", [2, 3, 5])
def test_rendezvous_rankings_match_reference(size):
    """The same member ranking per path as the reference (md5 of
    ``"path:engine"``), so both front doors send a path to the same
    members; scaling up appends, scaling down drops the tail."""
    for p in range(8):
        for e in range(size):
            assert ServingFleet._score(p, e) == JFleet._score(p, e)
        ranked = sorted(range(size), key=lambda e: ServingFleet._score(p, e),
                        reverse=True)
        assert len(set(ranked)) == size


def test_rendezvous_affinity_is_consistent(fleet_plane):
    opts = EngineOptions(registry=fleet_plane["reg"], cache_len=24,
                         slots_per_path=2)
    fleet = ServingFleet(fleet_plane["cfg"], size=3, options=opts,
                         backend="inproc")
    jfleet = JFleet(fleet_plane["jcfg"], size=3, backend="inproc",
                    options=JOptions(registry=fleet_plane["jreg"],
                                     cache_len=24, slots_per_path=2))
    for p in range(fleet.num_paths):
        ranks = []
        for n in (1, 2, 3):
            fleet.replicas[p] = jfleet.replicas[p] = n
            assert fleet.members(p) == jfleet.members(p)
            ranks.append(fleet.members(p))
        assert ranks[1][0] == ranks[0][0] and ranks[2][:2] == ranks[1]
        assert len(set(ranks[2])) == 3
        fleet.replicas[p] = 1


def test_fleet_autoscale_fans_out_and_decays(fleet_plane):
    opts = EngineOptions(registry=fleet_plane["reg"], cache_len=24,
                         slots_per_path=2)
    fleet = ServingFleet(fleet_plane["cfg"], size=3, options=opts,
                         backend="inproc")
    # 5 outstanding on path 0 at 2 slots a replica -> 3 replicas
    fleet._outstanding_by_path[0] = 5
    fleet.rebalance()
    assert fleet.replicas[0] == 3
    fleet._outstanding_by_path[0] = 0
    fleet.rebalance()
    assert fleet.replicas[0] == 1
    # backpressure alone fans out too; the cumulative counter is
    # delta-merged, so an unchanged count adds no new demand
    fleet.engines[0].scheduler.stats.starved_by_path[1] = 4
    fleet.rebalance()
    assert fleet.replicas[1] == 2
    fleet.rebalance()
    assert fleet.replicas[1] == 1
    assert fleet.stats["rebalances"] == 4


def test_fleet_inproc_tokens_and_spread_match_reference(fleet_plane):
    """The in-process fleet's greedy tokens, paths and member choices
    equal the JAX fleet's on the same weights and trace, and equal one
    engine's on the pre-routed trace; both members get traffic."""
    cfg, reg = fleet_plane["cfg"], fleet_plane["reg"]
    opts = EngineOptions(registry=reg, cache_len=24, slots_per_path=2)
    fleet = ServingFleet(cfg, size=2, options=opts, backend="inproc")
    jfleet = JFleet(fleet_plane["jcfg"], size=2, backend="inproc",
                    options=JOptions(registry=fleet_plane["jreg"],
                                     cache_len=24, slots_per_path=2))
    fins = fleet.serve_trace(_trace(cfg))
    jfins = jfleet.serve_trace(_trace(cfg, JRequest))
    assert [f.rid for f in fins] == [f.rid for f in jfins] == list(range(8))
    for f, g in zip(fins, jfins):
        np.testing.assert_array_equal(f.tokens, g.tokens)
        assert (f.path, f.priority, f.version) == \
            (g.path, g.priority, g.version)
    assert [s["ticks"] for s in fleet.member_stats()] == \
        [s["ticks"] for s in jfleet.member_stats()]
    assert fleet.stats == jfleet.stats and fleet.stats["routed"] == 8
    assert all(e.ticks > 0 for e in fleet.engines)
    single = ContinuousBatchingEngine(cfg, options=opts)
    trace = _trace(cfg)
    for r in trace:
        r.path = fleet.route_fn(r.prompt)
    ref = {f.rid: f for f in single.serve_trace(trace)}
    for f in fins:
        np.testing.assert_array_equal(f.tokens, ref[f.rid].tokens)


def test_fleet_promote_hot_swaps_every_member_inproc(fleet_plane):
    cfg, reg = fleet_plane["cfg"], fleet_plane["reg"]
    opts = EngineOptions(registry=reg, cache_len=24, slots_per_path=2)
    fleet = ServingFleet(cfg, size=2, options=opts, backend="inproc")
    fleet.serve_trace(_trace(cfg, n=4, seed=5))
    assert fleet.versions() == [1, 1]
    m2 = _mint_v2(reg, fleet_plane["tmp"] / "db")
    reg.promote(m2.version)
    fleet.wait_version(m2.version, timeout=60.0)
    assert fleet.versions() == [m2.version, m2.version]
    assert all(e.swaps == 1 for e in fleet.engines)
    fins = fleet.serve_trace(_trace(cfg, n=4, seed=6))
    assert {f.version for f in fins} == {m2.version}


def test_fleet_process_backend_end_to_end(tiny_cfg, tmp_path):
    """Two spawned engine processes on the CPU, each with its own
    registry handle on the same root (the base rebuilt from the seed):
    tokens equal an in-process member's, latency stamps in the front
    door's timebase, one promote moves both members, clean close."""
    cfg = get_smoke_config("dipaco-150m").replace(
        route_prefix_len=tiny_cfg.route_prefix_len)
    reg = DeploymentRegistry(cfg, DiPaCoConfig(levels=LEVELS),
                             str(tmp_path / "deploy"), seed=0, device="cpu")
    reg.promote(reg.register(note="v1").version)
    opts = EngineOptions(registry=reg, cache_len=24, slots_per_path=2,
                         prefix_cache=8)
    single = ContinuousBatchingEngine(cfg, options=opts)
    with ServingFleet(cfg, size=2, options=opts, backend="process",
                      seed=0) as fleet:
        assert fleet.versions() == [1, 1]
        trace = _trace(cfg, n=6, max_new=3)
        for r in trace:
            r.path = fleet.route_fn(r.prompt)
        ref = {f.rid: f for f in single.serve_trace(trace)}
        fins = fleet.serve_trace(_trace(cfg, n=6, max_new=3))
        assert [f.rid for f in fins] == list(range(6))
        for f in fins:
            np.testing.assert_array_equal(f.tokens, ref[f.rid].tokens)
            assert f.version == 1
        assert all(f.finished_at >= f.arrival >= 0.0 for f in fins)
        m2 = _mint_v2(reg, tmp_path / "db")
        reg.promote(m2.version)
        fleet.wait_version(m2.version, timeout=120.0)
        assert fleet.versions() == [m2.version, m2.version]
        fins = fleet.serve_trace(_trace(cfg, n=4, seed=6, max_new=3))
        assert {f.version for f in fins} == {m2.version}
    assert all(not pr.is_alive() for pr in fleet._procs)
    assert all(pr.exitcode == 0 for pr in fleet._procs)


def test_fleet_process_member_failure_raises(tiny_cfg, tmp_path):
    """A member that cannot start (a registry root with no serving
    version) ships its traceback, and the front door raises it."""
    cfg = get_smoke_config("dipaco-150m").replace(
        route_prefix_len=tiny_cfg.route_prefix_len)
    reg = DeploymentRegistry(cfg, DiPaCoConfig(levels=LEVELS),
                             str(tmp_path / "deploy"), seed=0, device="cpu")
    reg.register(note="v1")                     # never promoted
    with pytest.raises(RuntimeError, match="promote one first"):
        ServingFleet(cfg, size=1, backend="process", seed=0,
                     options=EngineOptions(registry=reg, cache_len=24))


def test_serve_launcher_deploy_root_and_fleet(tiny_cfg, tmp_path, capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--fleet", "2"])
    assert "--fleet requires --deploy-root" in capsys.readouterr().err
    cfg = get_smoke_config("dipaco-150m").replace(route_prefix_len=8)
    root = str(tmp_path / "deploy")
    reg = DeploymentRegistry(cfg, DiPaCoConfig(levels=LEVELS), root, seed=3,
                             device="cpu")
    reg.promote(reg.register(note="v1").version)
    common = ["--device", "cpu", "--deploy-root", root, "--levels", "2x2",
              "--seed", "3", "--requests", "4", "--prompt-len", "10",
              "--max-new", "3"]
    main(common + ["--engine", "continuous", "--swap-policy", "live"])
    out = capsys.readouterr().out
    assert "versions [1], serving v1" in out
    assert "served version(s) [1], hot swaps=0" in out
    main(common + ["--fleet", "2", "--fleet-backend", "inproc"])
    out = capsys.readouterr().out
    assert "fleet of 2 (inproc) on cpu: 12 tokens" in out
    assert "member versions [1, 1]" in out
    main(common)
    assert "serving version v1" in capsys.readouterr().out
