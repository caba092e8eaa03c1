"""The port's §3 training service (``make_trainer(backend="barrier" |
"service")``) on the CPU in f32: against the port's vector trainer and
the JAX package's ``InfraDiPaCoTrainer`` / ``TrainingService`` from the
same weights (per-phase losses to 1e-5, path parameters to 5e-6), the
pipelined service at lag 0 against the barrier bit for bit, kill and
resume at a phase boundary, mid-phase and at a fragment boundary bit for
bit, stragglers under a quorum and the staleness bound, the int8 wire
with 4 fragments, and a DB written by the JAX service resumed by the
port.  Every service gets a 60 s phase timeout and is shut down in a
``finally``."""
import tempfile
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.infra import TrainingService as JService
from repro.infra.trainer import InfraDiPaCoTrainer as JBarrier
from repro.models.config import DiPaCoConfig as JDiPaCoConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import pytree
from repro_torch.data import sharder
from repro_torch.infra import PhaseTimeoutError, TrainingService
from repro_torch.infra.trainer import InfraDiPaCoTrainer
from repro_torch.models.config import DiPaCoConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.training import make_trainer
from repro.data import sharder as jsharder

TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("dipaco-150m").replace(route_prefix_len=8,
                                                   attn_impl="pallas")


@pytest.fixture(scope="module")
def jcfg(tiny_cfg):
    return tiny_cfg.replace(attn_impl="chunked")


@pytest.fixture(scope="module")
def base(tiny_base):
    return jax.tree_util.tree_map(np.asarray, tiny_base[0])


def _ds(tiny_docs, k=4):
    docs, doms = tiny_docs
    return sharder.shard_documents(docs, doms % k, k)


def _jds(tiny_docs, k=4):
    docs, doms = tiny_docs
    return jsharder.shard_documents(docs, doms % k, k)


def _kw(base, **over):
    kw = dict(base_params=from_numpy_tree(base, device="cpu"), batch_size=4,
              peak_lr=1e-3, warmup=10, total_steps=100, num_workers=1,
              device="cpu", phase_timeout=TIMEOUT)
    kw.update(over)
    return kw


def _jkw(base, **over):
    kw = dict(key=jax.random.PRNGKey(0), base_params=base, batch_size=4,
              peak_lr=1e-3, warmup=10, total_steps=100, num_workers=1,
              phase_timeout=TIMEOUT)
    kw.update(over)
    return kw


def _leaves(tr, p):
    return [x.numpy() for x in pytree.leaves(tr.path_params(p))]


def _assert_paths(a, b, *, exact=False, atol=5e-6, num_paths=4):
    """Port trainer ``a`` against a port or JAX trainer ``b``."""
    for p in range(num_paths):
        mine = _leaves(a, p)
        other = b.path_params(p)
        theirs = ([np.asarray(x) for x in jax.tree_util.tree_leaves(other)]
                  if not isinstance(pytree.leaves(other)[0], torch.Tensor)
                  else [x.numpy() for x in pytree.leaves(other)])
        assert len(mine) == len(theirs)
        for x, y in zip(mine, theirs):
            if exact:
                assert x.tobytes() == y.tobytes()
            else:
                np.testing.assert_allclose(x, y, atol=atol, rtol=0)


class _Shut:
    """Shut every service down on the way out, whatever happened."""

    def __init__(self):
        self.items = []

    def __call__(self, x):
        self.items.append(x)
        return x

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for x in self.items:
            x.shutdown()
        return False


# ---------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------

def test_make_trainer_backends_and_device_rule(cfg, tiny_docs, base):
    ds = _ds(tiny_docs)
    from repro_torch.launch.train import MeshStreamingTrainer
    assert isinstance(make_trainer(cfg, DiPaCoConfig(levels=(2, 2)), ds,
                                   backend="mesh", device="cpu",
                                   base_params=from_numpy_tree(
                                       base, device="cpu")),
                      MeshStreamingTrainer)
    for backend in ("barrier", "service"):
        with pytest.raises(ValueError, match="ckpt_root"):
            make_trainer(cfg, DiPaCoConfig(), ds, backend=backend,
                         device="cpu")
    if not torch.cuda.is_available():
        with tempfile.TemporaryDirectory() as root:
            for backend in ("barrier", "service"):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    make_trainer(cfg, DiPaCoConfig(), ds, backend=backend,
                                 ckpt_root=root, base_params=from_numpy_tree(
                                     base, device="cpu"))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TrainingService(cfg, DiPaCoConfig(), ds, ckpt_root=root)
    with tempfile.TemporaryDirectory() as root, _Shut() as shut:
        tr = shut(make_trainer(cfg, DiPaCoConfig(levels=(2, 2)), ds,
                               backend="barrier", ckpt_root=root,
                               **_kw(base)))
        assert isinstance(tr, InfraDiPaCoTrainer)
        assert tr.service.device.type == "cpu"
        with pytest.raises(ValueError, match="comm_dtype"):
            TrainingService(cfg, DiPaCoConfig(comm_dtype="int2"), ds,
                            ckpt_root=root, **_kw(base))


def test_phase_timeout_and_threads_cleaned_up(cfg, tiny_docs, base):
    ds = _ds(tiny_docs)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=2)
    with tempfile.TemporaryDirectory() as root, _Shut() as shut:
        svc = shut(TrainingService(cfg, dcfg, ds, ckpt_root=root,
                                   **_kw(base)))
        svc.pool.handler = lambda task: time.sleep(0.7)   # never commits
        with pytest.raises(PhaseTimeoutError, match="clocks"):
            svc.run(1, tau=1, timeout=0.3)
    svc.shutdown()                          # idempotent
    for _ in range(50):
        if not any(t.name.startswith("svc-") for t in threading.enumerate()):
            break
        time.sleep(0.1)
    assert not any(t.name.startswith("svc-") for t in threading.enumerate())


# ---------------------------------------------------------------------
# against the vector trainer and the JAX package
# ---------------------------------------------------------------------

def test_barrier_matches_vector_under_preemption(cfg, tiny_docs, base):
    """The bar of tests/test_infra.py: 3 pool threads for 4 shards,
    preemptions, loss to 1e-5 and path parameters to 5e-6."""
    ds = _ds(tiny_docs)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=3)
    vec = make_trainer(cfg, dcfg, ds, backend="vector", **{
        k: v for k, v in _kw(base).items()
        if k not in ("num_workers", "phase_timeout")})
    with tempfile.TemporaryDirectory() as root, _Shut() as shut:
        bar = shut(make_trainer(cfg, dcfg, ds, backend="barrier",
                                ckpt_root=root,
                                **_kw(base, num_workers=3,
                                      preempt_prob=0.3)))
        for _ in range(2):
            m1, m2 = vec.run_phase(), bar.run_phase()
            assert abs(m1.mean_loss - m2["mean_loss"]) < 1e-5
        assert m2["preemptions"] > 0
        assert bar.service.pool.errors == 0
        for p in range(4):
            for x, y in zip(_leaves(bar, p), pytree.leaves(vec.path_params(p))):
                np.testing.assert_allclose(x, y.numpy(), atol=5e-6, rtol=0)


def test_barrier_and_service_match_reference(cfg, jcfg, tiny_docs, base):
    """From the same f32 weights: the port's barrier trainer against the
    JAX ``InfraDiPaCoTrainer`` (2 phases), and the port's pipelined
    service against the JAX ``TrainingService`` (``run(2)``), per-phase
    losses to 1e-5 and every path's parameters to 5e-6."""
    ds, jds = _ds(tiny_docs), _jds(tiny_docs)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=2)
    jdcfg = JDiPaCoConfig(levels=(2, 2), inner_steps=2)
    with tempfile.TemporaryDirectory() as r1, \
            tempfile.TemporaryDirectory() as r2, \
            tempfile.TemporaryDirectory() as r3, \
            tempfile.TemporaryDirectory() as r4, _Shut() as shut:
        tb = shut(InfraDiPaCoTrainer(cfg, dcfg, ds, ckpt_root=r1,
                                     **_kw(base, num_workers=2)))
        jb = shut(JBarrier(jcfg, jdcfg, jds, ckpt_root=r2,
                           **{k: v for k, v in _jkw(base).items()
                              if k != "phase_timeout"}))
        for _ in range(2):
            a, b = tb.run_phase(), jb.run_phase()
            np.testing.assert_allclose(a.per_path_loss, b.per_path_loss,
                                       rtol=0, atol=1e-5)
            assert a["outer_updates"] == b["outer_updates"]
        _assert_paths(tb, jb)
        ts = shut(TrainingService(cfg, dcfg, ds, ckpt_root=r3,
                                  max_phase_lag=1, **_kw(base)))
        js = shut(JService(jcfg, jdcfg, jds, ckpt_root=r4, max_phase_lag=1,
                           **_jkw(base)))
        a, b = ts.run(2), js.run(2)
        assert abs(a["mean_loss"] - b["mean_loss"]) < 1e-5
        assert a["outer_updates"] == b["outer_updates"]
        assert ts.losses.keys() == js.losses.keys()
        for k in ts.losses:
            assert abs(ts.losses[k] - js.losses[k]) < 1e-5
        _assert_paths(ts, js)


def test_int8_fragments_match_reference(cfg, jcfg, tiny_docs, base):
    """The int8 wire with 4 staggered fragments: the port's service
    against the JAX service.  Losses to 1e-5; the parameters to 5e-6
    except where a delta on a rounding tie of the int8 quantizer lands
    one step (its scale) away, carried by the outer step to the module's
    paths (a few elements in ten thousand)."""
    ds, jds = _ds(tiny_docs), _jds(tiny_docs)
    kw = dict(levels=(2, 2), inner_steps=2, outer_fragments=4,
              fragment_stagger=1, comm_dtype="int8")
    with tempfile.TemporaryDirectory() as r1, \
            tempfile.TemporaryDirectory() as r2, _Shut() as shut:
        ts = shut(TrainingService(cfg, DiPaCoConfig(**kw), ds, ckpt_root=r1,
                                  **_kw(base)))
        js = shut(JService(jcfg, JDiPaCoConfig(**kw), jds, ckpt_root=r2,
                           **_jkw(base)))
        for _ in range(2):
            a, b = ts.run(1), js.run(1)
            assert abs(a["mean_loss"] - b["mean_loss"]) < 1e-5
            assert a["comm"] == b["comm"]
        c = ts.comm_stats()
        assert c["total_comm_bytes"] == a["comm"]["total_comm_bytes"]
        assert 0.25 < c["wire_over_fp32"] < 0.26    # int8 + one scale a leaf
        for p in range(4):
            for x, y in zip(_leaves(ts, p), jax.tree_util.tree_leaves(
                    js.path_params(p))):
                d = np.abs(x - np.asarray(y))
                assert (d > 5e-6).sum() <= max(8, 1e-3 * d.size)
                assert d.max() < 1e-3


def test_port_resumes_a_reference_db(cfg, jcfg, tiny_docs, base):
    """A DB written by the JAX service (f32, 2 phases, killed) resumed by
    the port, which runs the third phase: the JAX run's path parameters
    to 1e-5."""
    ds, jds = _ds(tiny_docs), _jds(tiny_docs)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=2)
    jdcfg = JDiPaCoConfig(levels=(2, 2), inner_steps=2)
    with tempfile.TemporaryDirectory() as rA, \
            tempfile.TemporaryDirectory() as rB, _Shut() as shut:
        ref = shut(JService(jcfg, jdcfg, jds, ckpt_root=rA, **_jkw(base)))
        ref.run(3, tau=2)
        victim = shut(JService(jcfg, jdcfg, jds, ckpt_root=rB, **_jkw(base)))
        victim.run(2, tau=2)
        victim.shutdown()
        res = shut(TrainingService.resume(cfg, dcfg, ds, ckpt_root=rB,
                                          **_kw(base)))
        assert all(res.clock[s] == 2 for s in range(4))
        res.run(1, tau=2)
        _assert_paths(res, ref, atol=1e-5)


# ---------------------------------------------------------------------
# the port against itself: lag 0, kill and resume, stragglers
# ---------------------------------------------------------------------

def test_service_lag0_bitwise_equals_barrier(cfg, tiny_docs, base):
    ds = _ds(tiny_docs)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=2)
    with tempfile.TemporaryDirectory() as r1, \
            tempfile.TemporaryDirectory() as r2, _Shut() as shut:
        svc = shut(TrainingService(cfg, dcfg, ds, ckpt_root=r1,
                                   max_phase_lag=0, **_kw(base)))
        m_async = svc.run(2, tau=2)
        tr = shut(InfraDiPaCoTrainer(cfg, dcfg, ds, ckpt_root=r2,
                                     **_kw(base)))
        tr.run_phase(tau=2)
        m_barrier = tr.run_phase(tau=2)
        assert m_async["mean_loss"] == m_barrier["mean_loss"]
        assert m_async["outer_updates"] == m_barrier["outer_updates"]
        _assert_paths(svc, tr, exact=True)


def test_kill_and_resume_bit_compatible(cfg, tiny_docs, base):
    ds = _ds(tiny_docs)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=2)
    with tempfile.TemporaryDirectory() as rA, \
            tempfile.TemporaryDirectory() as rB, _Shut() as shut:
        ref = shut(TrainingService(cfg, dcfg, ds, ckpt_root=rA,
                                   **_kw(base)))
        ref.run(3, tau=2)
        victim = shut(TrainingService(cfg, dcfg, ds, ckpt_root=rB,
                                      **_kw(base)))
        victim.run(2, tau=2)
        victim.shutdown()                      # "kill"
        res = shut(TrainingService.resume(cfg, dcfg, ds, ckpt_root=rB,
                                          **_kw(base)))
        assert all(res.clock[s] == 2 for s in range(4))
        res.run(1, tau=2)
        _assert_paths(ref, res, exact=True)
        for ph in range(3):
            for s in range(4):
                assert ref.losses[(ph, s)] == res.losses[(ph, s)]


def _poisoned_run(cfg, dcfg, ds, base, root, shut):
    """Run phase 0, then lose shard 3's phase-1 task with no retry."""
    victim = shut(TrainingService(cfg, dcfg, ds, ckpt_root=root,
                                  max_attempts=1, **_kw(base)))
    victim.run(1, tau=2)
    inner = victim._handle

    def poison(task, _inner=inner):
        if task.payload["shard_id"] == 3 and task.payload["phase"] == 1:
            raise RuntimeError("injected machine loss")
        return _inner(task)

    victim.pool.handler = poison
    with pytest.raises(PhaseTimeoutError):
        victim.run(1, tau=2, timeout=8.0)
    assert victim.clock == {0: 2, 1: 2, 2: 2, 3: 1}    # mid-phase
    assert victim.pool.errors == 1
    return victim


@pytest.mark.parametrize("where", ["mid_phase", "fragment_boundary"])
def test_midphase_kill_resume_bit_compatible(cfg, tiny_docs, base, where):
    """Killed mid-phase (one shard's task lost), and at a fragment
    boundary (slot-0 fragments of the committed shards folded, their
    staggered fragments in flight, an int8 residual a shard): the resume
    rebuilds the partial windows and the in-flight set and continues bit
    for bit."""
    ds = _ds(tiny_docs)
    kw = dict(levels=(2, 2), inner_steps=2)
    if where == "fragment_boundary":
        kw.update(outer_fragments=3, fragment_stagger=1, comm_dtype="int8")
    dcfg = DiPaCoConfig(**kw)
    with tempfile.TemporaryDirectory() as rA, \
            tempfile.TemporaryDirectory() as rB, _Shut() as shut:
        ref = shut(TrainingService(cfg, dcfg, ds, ckpt_root=rA,
                                   **_kw(base)))
        for _ in range(3):          # the victim's run()-flush points
            ref.run(1, tau=2)
        victim = _poisoned_run(cfg, dcfg, ds, base, rB, shut)
        inflight = victim.pending_fragments
        if where == "fragment_boundary":
            assert inflight == [(s, 1, f) for s in range(3) for f in (1, 2)]
        victim.shutdown()
        res = shut(TrainingService.resume(cfg, dcfg, ds, ckpt_root=rB,
                                          **_kw(base)))
        assert res.clock == {0: 2, 1: 2, 2: 2, 3: 1}
        assert res._snapshots[3][0] == 1
        assert res.pending_fragments == inflight
        if where == "fragment_boundary":
            assert all(res._qresid[s] is not None for s in range(3))
        res.run(0, tau=2)                  # finish the outstanding phase
        assert res.pending_fragments == []
        res.run(1, tau=2)
        _assert_paths(ref, res, exact=True)


def test_async_stragglers_quorum_and_staleness_bound(cfg, tiny_docs, base):
    ds = _ds(tiny_docs)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=2, async_quorum=0.5)
    with tempfile.TemporaryDirectory() as root, _Shut() as shut:
        svc = shut(TrainingService(cfg, dcfg, ds, ckpt_root=root,
                                   max_phase_lag=1,
                                   **_kw(base, num_workers=2,
                                         preempt_prob=0.3)))
        inner = svc._handle

        def straggler(task, _inner=inner):
            if task.payload["shard_id"] == 0:
                time.sleep(0.1)
            return _inner(task)

        svc.pool.handler = straggler
        m = svc.run(3, tau=2)
        assert all(svc.clock[s] == 3 for s in range(4))
        assert m["max_observed_lag"] == 1
        assert m["outer_updates"] > 15
        assert np.isfinite(m["mean_loss"]) and svc.pool.errors == 0


def test_reference_resumes_a_port_db(cfg, jcfg, tiny_docs, base):
    """The other way round: a DB written by the port's service (f32, 2
    phases, killed) resumed by the JAX service for a third phase: the
    port's uninterrupted run's path parameters to 1e-5."""
    ds, jds = _ds(tiny_docs), _jds(tiny_docs)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=2)
    jdcfg = JDiPaCoConfig(levels=(2, 2), inner_steps=2)
    with tempfile.TemporaryDirectory() as rA, \
            tempfile.TemporaryDirectory() as rB, _Shut() as shut:
        ref = shut(TrainingService(cfg, dcfg, ds, ckpt_root=rA,
                                   **_kw(base)))
        ref.run(3, tau=2)
        victim = shut(TrainingService(cfg, dcfg, ds, ckpt_root=rB,
                                      **_kw(base)))
        victim.run(2, tau=2)
        victim.shutdown()
        res = shut(JService.resume(jcfg, jdcfg, jds, ckpt_root=rB,
                                   **_jkw(base)))
        assert all(res.clock[s] == 2 for s in range(4))
        res.run(1, tau=2)
        _assert_paths(ref, res, atol=1e-5)


@pytest.mark.parametrize("backend", ["barrier", "service"])
def test_launcher_runs_the_service_on_cpu(capsys, tmp_path, backend):
    from repro_torch.launch.train import main
    res = main(["--device", "cpu", "--smoke", "--docs", "64", "--tau", "2",
                "--phases", "2", "--seq", "48", "--backend", backend,
                "--ckpt-root", str(tmp_path), "--num-workers", "2",
                "--comm-dtype", "int8", "--fragments", "2"])
    out = capsys.readouterr().out
    assert "[phase 1]" in out and "[done]" in out
    assert ("[comm]" in out) == (backend == "service")
    assert all(np.isfinite(res["phase_loss"])) and np.isfinite(res["ppl"])
    assert (tmp_path / "rows.jsonl").exists()
    assert not any(t.name.startswith("svc-") and t.is_alive()
                   for t in threading.enumerate())
