"""The port's ``"mesh"`` backend across processes on the CPU: spawned
gloo worlds of 2, 4 and 8 ranks, each rank holding its own worker rows,
against the single-process streaming oracle
(``core.diloco.segmented_streaming_phase``) bit for bit, for fp32, int8
and int4 wires and for K = 1 and K >= 2 fragments; and the
``MeshStreamingTrainer`` across 2 ranks (kill and resume, collective
``path_params``) against the same trainer in a world of one.

Every rank and the oracle run on one torch thread, so that the matmuls
sum in the same order.  Each world gets a process-group timeout and a
join deadline: a collective that hangs fails its test.

This module imports no JAX: the spawned ranks import it to find their
entry point, ``rank_main``.
"""
import datetime
import multiprocessing as mp
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core import pytree
from repro_torch.core.diloco import (fragment_state_init,
                                     segmented_streaming_phase)
from repro_torch.core.dipaco import stack_tree
from repro_torch.core.fragments import FragmentSpec, segment_bounds
from repro_torch.core.partition import make_partition, mixing_matrices
from repro_torch.data import SyntheticCorpus, shard_documents
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.launch.steps import (make_segment_scan_fn,
                                      make_streaming_mesh_phase)
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import param_axes
from repro_torch.optim import adamw_init

THREADS = 1
PG_TIMEOUT_S = 60
JOIN_DEADLINE_S = 120


def smoke_cfg():
    return get_smoke_config("dipaco-150m").replace(route_prefix_len=8,
                                                   attn_impl="pallas")


def _clone(tree):
    return pytree.tree_map(lambda x: x.clone(), tree)


def case_inputs(cfg, *, W, K, tau, B=2, T=32, seed=0, base=None) -> dict:
    """One phase's inputs for W workers, made from ``seed``: the base
    weights (``base``, else made from the seed) stacked W times (workers
    in the config's dtype, f32 global copies), fresh AdamW and fragment
    states, the 2x2 mixing matrices, and each segment's token batches
    (S, W, B, T) and learning rates; ``tokens`` and ``lrs`` keep the
    numpy arrays they came from."""
    if base is None:
        base = api.init_model(cfg, seed=seed, device="cpu")
    worker = stack_tree(base, W)
    glob = stack_tree(pytree.tree_map(lambda x: x.float(), base), W)
    spec = FragmentSpec(glob, K)
    part = make_partition(DiPaCoConfig(levels=(2, 2)), cfg.pattern_repeats)
    mixl, mixs = mixing_matrices(part, np.arange(W) % part.num_paths)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (tau, W, B, T)).astype(np.int32)
    lr_np = np.linspace(1e-3, 5e-4, tau, dtype=np.float32)
    batches, lrs = torch.as_tensor(tokens), torch.as_tensor(lr_np)
    bounds = segment_bounds(tau, K)
    return {"worker": worker, "glob": glob, "opt": stack_tree(
                adamw_init(base), W),
            "states": fragment_state_init(glob, spec), "spec": spec,
            "axes": param_axes(cfg), "mixl": torch.as_tensor(mixl),
            "mixs": torch.as_tensor(mixs),
            "seg_b": [batches[bounds[s]:bounds[s + 1]] for s in range(K)],
            "seg_l": [lrs[bounds[s]:bounds[s + 1]] for s in range(K)],
            "tokens": tokens, "lrs": lr_np}


def run_oracle(cfg, inp, comm_dtype) -> tuple:
    """The single-process oracle, driven by the segment function the mesh
    phase uses: (worker, global, fragment states, residuals)."""
    seg_fn = make_segment_scan_fn(cfg)
    opt = [_clone(inp["opt"])]

    def inner_seg(s, wp):
        wp, opt[0], _ = seg_fn(wp, opt[0], inp["seg_b"][s], inp["seg_l"][s])
        return wp

    return segmented_streaming_phase(
        inner_seg, _clone(inp["worker"]), _clone(inp["glob"]),
        [dict(s) for s in inp["states"]], {}, inp["axes"], inp["mixl"],
        inp["mixs"], inp["spec"], comm_dtype=comm_dtype)


def run_mesh_phase(cfg, inp, comm_dtype, mesh) -> tuple:
    """The mesh phase on this rank's rows of ``inp``: (worker, global,
    fragment states, residuals, losses), each over the rank's rows."""
    rows = slice(mesh.rows.start, mesh.rows.stop)

    def mine(tree):
        return pytree.tree_map(lambda x: x[rows].clone(), tree)

    phase = make_streaming_mesh_phase(cfg, mesh, inp["axes"], inp["spec"],
                                      comm_dtype=comm_dtype)
    wp, _, gp, st, res, losses = phase(
        mine(inp["worker"]), mine(inp["opt"]), mine(inp["glob"]),
        [mine(s) for s in inp["states"]], {}, inp["mixl"], inp["mixs"],
        [b[:, rows] for b in inp["seg_b"]], inp["seg_l"])
    return wp, gp, st, res, losses


def assert_bitexact(a, b) -> None:
    la, lb = pytree.leaves(a), pytree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


# ---------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------

def _phase_job(case: dict) -> dict:
    cfg = smoke_cfg()
    inp = case_inputs(cfg, W=case["W"], K=case["K"], tau=case["tau"])
    mesh = make_worker_mesh(case["W"], device="cpu")
    wp, gp, st, res, losses = run_mesh_phase(cfg, inp, case["dtype"], mesh)
    return {"rows": list(mesh.rows), "out": (wp, gp, st, res),
            "losses": losses}


def _trainer_job(case: dict) -> dict:
    """3 phases uninterrupted, and 2 phases + kill + resume + 1 phase
    from the phase-state file, through ``make_trainer``; the second
    must equal the first on this rank's rows and on every path."""
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.training import make_trainer
    cfg = smoke_cfg()
    ds = shard_documents(case["docs"], case["doms"] % 4, 4)
    kw = dict(base_params=from_numpy_tree(case["base"], device="cpu"),
              batch_size=2, peak_lr=1e-3, warmup=4, total_steps=24,
              device="cpu")
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=4, outer_fragments=2,
                        comm_dtype="int8")
    ref = make_trainer(cfg, dcfg, ds, backend="mesh", **kw)
    metrics = [ref.run_phase() for _ in range(3)]
    vic = make_trainer(cfg, dcfg, ds, backend="mesh",
                       ckpt_root=case["root"], **kw)
    vic.run_phase()
    vic.run_phase()
    del vic
    res = make_trainer(cfg, dcfg, ds, backend="mesh",
                       ckpt_root=case["root"], resume=True, **kw)
    resumed = {"phase": res.phase, "step": res.step}
    res.run_phase()
    for a, b in ((ref.worker_params, res.worker_params),
                 (ref.global_params, res.global_params),
                 (ref.residuals, res.residuals),
                 (ref.frag_states, res.frag_states)):
        assert_bitexact(a, b)
    paths = [_clone(ref.path_params(p)) for p in range(4)]
    for p in range(4):
        assert_bitexact(paths[p], res.path_params(p))
    return {"rows": list(ref.rows), "resumed": resumed, "paths": paths,
            "losses": [m.mean_loss for m in metrics],
            "comm": metrics[-1]["comm"]}


_JOBS = {"phase": _phase_job, "trainer": _trainer_job}


def rank_main(rank: int, world: int, port: int, jobs: list, out: str):
    """Entry point of a spawned rank: join the gloo world, run ``jobs``
    (``(name, kind, case)`` triples) in order, save what each returns."""
    torch.set_num_threads(THREADS)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        got = {name: _JOBS[kind](case) for name, kind, case in jobs}
        torch.save(got, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world: int, jobs: list, out) -> list:
    """Spawn ``world`` ranks running ``jobs``; every rank must exit 0
    before the join deadline.  -> each rank's results, in rank order."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, jobs, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + JOIN_DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, (f"ranks {hung} of a world of {world} still ran "
                          f"after {JOIN_DEADLINE_S} s")
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(f"{out}/rank{r}.pt") for r in range(world)]


# ---------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _pinned_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


# every world runs several cases; between them, fp32, int8 and int4 and
# K = 1 and K >= 2 each cross a process boundary
WORLDS = {
    2: [dict(W=4, K=2, tau=4, dtype="fp32"), dict(W=4, K=1, tau=3,
                                                    dtype="int8")],
    4: [dict(W=4, K=2, tau=4, dtype="int4"), dict(W=4, K=1, tau=3,
                                                    dtype="fp32")],
    8: [dict(W=8, K=3, tau=6, dtype="int8")],
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_spawned_world_bitexact_vs_oracle(world, tmp_path):
    """Each rank's rows of the worker params, global copies, fragment
    states and residuals after one phase equal the oracle's rows bit for
    bit, and every rank holds the same losses of its own workers."""
    cases = WORLDS[world]
    ranks = run_world(world, [(f"c{i}", "phase", c)
                              for i, c in enumerate(cases)], tmp_path)
    cfg = smoke_cfg()
    for i, case in enumerate(cases):
        inp = case_inputs(cfg, W=case["W"], K=case["K"], tau=case["tau"])
        oracle = run_oracle(cfg, inp, case["dtype"])
        per = case["W"] // world
        for r, got in enumerate(ranks):
            got = got[f"c{i}"]
            assert got["rows"] == list(range(r * per, (r + 1) * per))
            rows = slice(r * per, (r + 1) * per)
            want = (pytree.tree_map(lambda x: x[rows], oracle[0]),
                    pytree.tree_map(lambda x: x[rows], oracle[1]),
                    [pytree.tree_map(lambda x: x[rows], s)
                     for s in oracle[2]],
                    pytree.tree_map(lambda x: x[rows], oracle[3]))
            for a, b in zip(want, got["out"]):
                assert_bitexact(a, b)
            assert got["losses"].shape == (case["tau"], per)
            assert torch.isfinite(got["losses"]).all()


def test_spawned_trainer_resume_and_paths(tmp_path):
    """``make_trainer(backend="mesh")`` across 2 ranks: kill and resume
    from the phase-state file equals 3 uninterrupted phases bit for bit
    (checked in the ranks), and every path's parameters, the losses and
    the comm accounting equal the same trainer's in a world of one."""
    from repro_torch.models.params import from_numpy_tree, to_numpy_tree
    from repro_torch.training import make_trainer
    cfg = smoke_cfg()
    docs, doms = SyntheticCorpus(vocab_size=512, num_domains=4, seq_len=64,
                                 seed=0).sample_documents(
                                     256, return_domains=True)
    base = to_numpy_tree(api.init_model(cfg, seed=0, device="cpu"))
    root = tmp_path / "ckpt"
    case = {"docs": docs, "doms": doms, "base": base, "root": str(root)}
    ranks = run_world(2, [("t", "trainer", case)], tmp_path)
    assert sorted(p.name for p in root.iterdir()) == [
        "mesh_phase_000001.npz", "mesh_phase_000002.npz",
        "mesh_phase_000003.npz"]
    one = make_trainer(
        cfg, DiPaCoConfig(levels=(2, 2), inner_steps=4, outer_fragments=2,
                          comm_dtype="int8"),
        shard_documents(docs, doms % 4, 4), backend="mesh", device="cpu",
        base_params=from_numpy_tree(base, device="cpu"), batch_size=2,
        peak_lr=1e-3, warmup=4, total_steps=24)
    metrics = [one.run_phase() for _ in range(3)]
    for r, got in enumerate(ranks):
        got = got["t"]
        assert got["rows"] == [2 * r, 2 * r + 1]
        assert got["resumed"] == {"phase": 2, "step": 8}
        assert got["losses"] == [m.mean_loss for m in metrics]
        assert got["comm"] == metrics[-1]["comm"]
        for p in range(4):
            assert_bitexact(one.path_params(p), got["paths"][p])
