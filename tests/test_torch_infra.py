"""The port's copies of the §3 task queue, barrier, worker pool and
monitor, held to the JAX package's tests of the originals
(``tests/test_infra.py``, ``tests/test_training_service.py``) and to the
originals' snapshot JSON; the pool's handler-error count; the transports
and the fleet's worker profiles; and the kernel loader's and launch
counters' thread safety."""
import ast
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.infra import task_queue as jtq
from repro.infra import transport as jtransport
from repro_torch.core import pytree
from repro_torch.infra import (FaultInjector, MeshTransport, Monitor,
                               RetryingTransport, RetryPolicy, Task,
                               TaskQueue, TransportError, WorkerPool,
                               WorkerProfile, make_transport)
from repro_torch.infra import task_queue as ttq
from repro_torch.infra.task_queue import Barrier
from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]


def test_task_queue_is_a_copy_of_the_reference():
    """Line for line, but the module docstring."""
    def body(path):
        tree = ast.parse(path.read_text())
        tree.body = tree.body[1:]
        return ast.dump(tree)
    assert body(ROOT / "src/repro_torch/infra/task_queue.py") == \
        body(ROOT / "src/repro/infra/task_queue.py")


def test_queue_snapshot_json_equals_reference():
    for mod in (ttq, jtq):
        q = mod.TaskQueue()
        q.put_many([mod.Task("train", {"i": i}, task_id=f"t{i}")
                    for i in range(3)])
        q.fetch(timeout=0.1)
        if mod is ttq:
            mine = q.snapshot()
        else:
            theirs = q.snapshot()
    assert mine == theirs
    assert TaskQueue.restore(theirs).stats() == \
        jtq.TaskQueue.restore(mine).stats()


def test_queue_basic_flow():
    q = TaskQueue()
    q.put_many([Task("train", {"i": i}) for i in range(5)])
    seen = []
    while True:
        t = q.fetch(timeout=0.1)
        if t is None:
            break
        seen.append(t.payload["i"])
        q.complete(t.task_id, t.payload["i"] * 2)
    assert sorted(seen) == list(range(5))
    assert q.stats()["done"] == 5
    assert sorted(q.results().values()) == [0, 2, 4, 6, 8]


def test_queue_lease_expiry_requeues():
    q = TaskQueue(lease_seconds=0.1)
    q.put(Task("train", {"i": 0}))
    t1 = q.fetch(timeout=0.5)
    assert t1 is not None
    time.sleep(0.2)
    t2 = q.fetch(timeout=0.5)
    assert t2 is not None and t2.task_id == t1.task_id
    assert t2.attempts == 2


def test_queue_fail_requeues_until_max_attempts():
    q = TaskQueue(max_attempts=3)
    q.put(Task("train", {}))
    for _ in range(3):
        t = q.fetch(timeout=0.2)
        q.fail(t.task_id, "boom")
    assert q.fetch(timeout=0.1) is None
    assert q.stats()["failed"] == 1


def test_queue_snapshot_restore():
    q = TaskQueue()
    q.put_many([Task("train", {"i": i}) for i in range(3)])
    q.fetch(timeout=0.1)
    q2 = TaskQueue.restore(q.snapshot())
    assert q2.stats()["pending"] == 3


def test_queue_renew_lease_cancel_and_closed_put():
    q = TaskQueue(lease_seconds=0.2)
    q.put(Task("w", {}))
    t = q.fetch(timeout=0.5)
    for _ in range(3):
        time.sleep(0.1)
        assert q.renew_lease(t.task_id)
    assert q.fetch(timeout=0.05) is None
    q.complete(t.task_id)
    assert not q.renew_lease(t.task_id)
    q.put_many([Task("w", {"shard_id": s}) for s in range(4)])
    dropped = q.cancel(lambda t: t.payload["shard_id"] % 2)
    assert sorted(t.payload["shard_id"] for t in dropped) == [1, 3]
    q.close()
    with pytest.raises(RuntimeError):
        q.put(Task("w", {}))


def test_barrier():
    b = Barrier(3)
    results = []
    ts = [threading.Thread(target=lambda: results.append(
        b.wait("phase0", timeout=5.0))) for _ in range(3)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert results == [True, True, True]
    assert Barrier(2).wait("lonely", timeout=0.1) is False


def test_worker_pool_with_preemptions_completes_all():
    q = TaskQueue(lease_seconds=5.0, max_attempts=50)
    q.put_many([Task("w", {"i": i}) for i in range(20)])
    done = []
    pool = WorkerPool(q, lambda t: done.append(t.payload["i"]),
                      num_workers=4, preempt_prob=0.4, seed=1).start()
    mon = Monitor(pool, period=0.02).start()
    try:
        assert q.join(timeout=30.0)
    finally:
        q.close()
        mon.stop()
        pool.stop()
    assert sorted(set(done)) == list(range(20))
    assert pool.preemptions > 0 and pool.errors == 0


def test_preempted_worker_dies_monitor_restarts_fresh_ids():
    q = TaskQueue(lease_seconds=5.0, max_attempts=100)
    q.put_many([Task("w", {"i": i}) for i in range(12)])
    done = []
    pool = WorkerPool(q, lambda t: done.append(t.payload["i"]),
                      num_workers=2, preempt_prob=0.5, seed=3).start()
    mon = Monitor(pool, period=0.02).start()
    try:
        assert q.join(timeout=30.0)
    finally:
        q.close()
        mon.stop()
        pool.stop()
    assert sorted(set(done)) == list(range(12))
    assert pool.preemptions > 0 and mon.restarts > 0
    assert len(set(pool.spawned)) == len(pool.spawned)
    assert max(pool.spawned) >= pool.num_workers


def test_worker_pool_counts_handler_errors():
    """A handler exception (a kernel failing on the card, say) requeues
    the task as the reference does, and is counted with its traceback."""
    q = TaskQueue(lease_seconds=5.0, max_attempts=3)
    q.put(Task("w", {"i": 0}))
    calls = []

    def handler(task):
        calls.append(task.attempts)
        if task.attempts < 3:
            raise RuntimeError("kernel launch failed: cudaError 700")

    pool = WorkerPool(q, handler, num_workers=1).start()
    try:
        assert q.join(timeout=10.0)
    finally:
        q.close()
        pool.stop()
    assert calls == [1, 2, 3] and pool.errors == 2
    assert "cudaError 700" in pool.last_error
    assert pool.completed == 1 and pool.preemptions == 0


def test_pool_resize_and_monitor_follow_target():
    q = TaskQueue(lease_seconds=5.0)
    pool = WorkerPool(q, lambda t: None, num_workers=2).start()
    mon = Monitor(pool, period=0.02).start()
    try:
        pool.resize(4)
        for _ in range(100):
            if pool.alive_count() == 4:
                break
            time.sleep(0.02)
        assert pool.alive_count() == 4
        pool.resize(1)
        for _ in range(200):
            if pool.alive_count() == 1:
                break
            time.sleep(0.02)
        assert pool.alive_count() == 1
    finally:
        q.close()
        mon.stop()
        pool.stop()


def test_transports_and_fault_injection_match_reference():
    mesh = make_transport("mesh", devices=[torch.device("cpu")])
    assert isinstance(mesh, MeshTransport) and mesh.name == "mesh"
    assert isinstance(make_transport("mesh", devices=["cpu"], retries=1)
                      .inner, MeshTransport)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_transport("mesh")
    with pytest.raises(ValueError):
        make_transport("carrier-pigeon")
    t = make_transport("inproc")
    wire = {"x": torch.ones(3)}
    assert t.ship(0, wire, wire) is wire and t.stats["sends"] == 1
    assert isinstance(make_transport("inproc", retries=2),
                      RetryingTransport)
    # the fault schedule is a pure function of its key: the reference's
    kw = dict(seed=7, drop=0.2, dup=0.1, delay=0.1, corrupt=0.2)
    mine, theirs = FaultInjector(**kw), jtransport.FaultInjector(**kw)
    for shard in range(3):
        for phase in range(3):
            for att in range(3):
                assert mine.action(shard, phase, 0, att) == \
                    theirs.action(shard, phase, 0, att)
    assert RetryPolicy().backoff(5) == jtransport.RetryPolicy().backoff(5)
    # corruption is caught by the checksum and retried; exhaustion raises
    payload = {"q": torch.arange(6, dtype=torch.int8),
               "scale": torch.tensor(0.5)}
    inj = FaultInjector(seed=1, corrupt=1.0)
    rt = RetryingTransport(make_transport("inproc"),
                           policy=RetryPolicy(retries=2), injector=inj,
                           sleep=lambda s: None)
    with pytest.raises(TransportError) as err:
        rt.ship(3, payload, payload, phase=1)
    assert err.value.attempts == 3 and rt.stats["checksum_rejects"] == 3
    bad = inj.corrupt_payload(payload, 3, 1, 0, 0)
    assert any(not np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(pytree.leaves(bad), pytree.leaves(payload)))
    with pytest.raises(ValueError):
        WorkerProfile(bandwidth=0.0)


def test_kernel_loader_builds_once_across_threads(monkeypatch, tmp_path):
    """Eight threads' first ``load`` of one kernel: the (slow) build runs
    once, and every thread gets the same library handle."""
    builds, handles = [], []
    missing = tmp_path / "fake.so"

    def slow_build(names):
        builds.append(tuple(names))
        time.sleep(0.2)
        missing.write_bytes(b"")

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "lib_path", lambda name: missing)
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    start = threading.Barrier(8)

    def worker():
        start.wait()
        handles.append(build.load("flash_attention"))

    ts = [threading.Thread(target=worker) for _ in range(8)]
    [t.start() for t in ts]
    for t in ts:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in ts)
    assert builds == [("flash_attention",)]
    assert len(handles) == 8 and all(h is handles[0] for h in handles)


def test_launch_counters_are_thread_safe():
    """16 threads bump one counter with a short switch interval: no
    update is lost."""
    def wrapper():
        pass
    wrapper.launches = 0

    def bump():
        for _ in range(2000):
            build.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=bump) for _ in range(16)]
        [t.start() for t in ts]
        for t in ts:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 32000
