"""Thread worker pool with preemption injection (paper §3.1, §3.4); the
port of ``repro/infra/worker_pool.py``.

Workers repeatedly fetch tasks from the queue and run a handler.  A
``preempt_prob`` simulates low-tier backup-pool preemptions: the worker
"dies" mid-task — the task is failed back to the queue (its lease
expires / fail() requeues it) AND the worker thread terminates, exactly
like a reclaimed machine.  Capacity only comes back when the ``Monitor``
(§3 step 6) notices the dead thread and restarts a replacement, so
monitor restarts are genuinely exercised, not dead code.  Handler bugs
(any non-``Preempted`` exception) requeue the task but keep the worker
alive, as the reference's do; the port also counts them (``errors``) and
keeps the last traceback (``last_error``), so a kernel that fails on the
card in a worker thread is retried but never hidden.
"""
from __future__ import annotations

import random
import threading
import time
import traceback
from typing import Callable

from repro_torch.obs import as_telemetry

from .task_queue import Task, TaskQueue


class Preempted(RuntimeError):
    pass


class WorkerPool:
    def __init__(self, queue: TaskQueue, handler: Callable[[Task], object],
                 *, num_workers: int = 4, preempt_prob: float = 0.0,
                 preempt_for: Callable[[Task], float] | None = None,
                 seed: int = 0, name: str = "pool", telemetry=None):
        self.queue = queue
        self.handler = handler
        self.tel = as_telemetry(telemetry)
        self.num_workers = num_workers
        self.preempt_prob = preempt_prob
        # heterogeneous fleets: per-task preemption rate (e.g. from the
        # reporting shard's WorkerProfile); overrides preempt_prob
        self.preempt_for = preempt_for
        self.rng = random.Random(seed)
        self.name = name
        self._threads: list = []
        self._stop = threading.Event()
        self.completed = 0
        self.preemptions = 0
        # handler exceptions other than Preempted: requeued, counted
        self.errors = 0
        self.last_error: str | None = None
        self._lock = threading.Lock()
        # serializes capacity reconciliation: only one caller (resize
        # or Monitor) may be spawning toward the target at a time, and
        # each spawn re-checks the deficit — a Monitor tick landing
        # between a resize's target bump and its spawns must not spawn
        # the same workers again (over-spawn is permanent: nothing
        # retires extras)
        self._spawn_lock = threading.Lock()
        self._next_wid = 0
        self._retire = 0            # threads asked to exit (downsize)
        self.spawned: list = []     # every worker id ever started

    def _run(self, wid: int):
        while not self._stop.is_set():
            with self._lock:
                if self._retire > 0:
                    # capacity shrink: this machine is returned to the
                    # provider; its thread exits without a replacement
                    self._retire -= 1
                    self._threads = [t for t in self._threads
                                     if t is not threading.current_thread()]
                    return
            task = self.queue.fetch(timeout=0.2)
            if task is None:
                if self.queue._closed:
                    return
                continue
            try:
                p = (self.preempt_for(task) if self.preempt_for
                     else self.preempt_prob)
                if self.rng.random() < p:
                    with self._lock:
                        self.preemptions += 1
                    self.tel.instant("pool.preempt", worker=wid,
                                     pool=self.name)
                    raise Preempted(f"worker {wid} preempted")
                with self.tel.span("pool.task", worker=wid,
                                   kind=task.kind):
                    result = self.handler(task)
                self.queue.complete(task.task_id, result)
                with self._lock:
                    self.completed += 1
            except Preempted as e:
                self.queue.fail(task.task_id, str(e))
                return    # the machine is gone; only Monitor restores it
            except Exception as e:  # noqa: BLE001 - handler bug -> requeue
                tb = traceback.format_exc()
                with self._lock:
                    self.errors += 1
                    self.last_error = tb
                self.queue.fail(task.task_id, f"{e}\n{tb[-500:]}")

    def spawn_worker(self) -> threading.Thread:
        """Start one worker on a fresh id — never reuses the id of a
        live worker (the Monitor-restart id-collision bug)."""
        with self._lock:
            wid = self._next_wid
            self._next_wid += 1
            self.spawned.append(wid)
        t = threading.Thread(target=self._run, args=(wid,),
                             name=f"{self.name}-{wid}", daemon=True)
        t.start()
        with self._lock:
            self._threads.append(t)
        return t

    def start(self):
        self._reconcile()
        return self

    def resize(self, num_workers: int) -> None:
        """Elastic capacity change: grow by spawning fresh workers,
        shrink by asking surplus threads to retire at their next fetch
        (the Monitor's restart target follows ``num_workers``)."""
        num_workers = max(0, int(num_workers))
        with self._lock:
            cur = len([t for t in self._threads if t.is_alive()])
            self.num_workers = num_workers
            delta = num_workers - (cur - self._retire)
            if delta < 0:
                self._retire += -delta
            else:
                self._retire -= min(delta, self._retire)
        self._reconcile()

    def _reconcile(self) -> int:
        """Spawn workers toward ``num_workers`` (net of pending
        retires); returns how many were spawned.  The deficit is
        snapshotted once *inside* ``_spawn_lock``, so a concurrent
        resize/Monitor pair can never double-spawn toward one target —
        the second caller's snapshot already sees the first caller's
        spawns.  Deliberately NOT a converge loop: a worker dying while
        we spawn (high preempt rate) waits for the next Monitor tick,
        keeping restarts period-paced instead of a hot respawn spin."""
        spawned = 0
        with self._spawn_lock:
            with self._lock:
                alive = [t for t in self._threads if t.is_alive()]
                self._threads = alive
                budget = self.num_workers - len(alive) + self._retire
            while spawned < budget and not self._stop.is_set():
                self.spawn_worker()
                spawned += 1
        return spawned

    def alive_count(self) -> int:
        with self._lock:
            return len([t for t in self._threads if t.is_alive()])

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        cur = threading.current_thread()
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            if t is not cur:      # stop() may run on a pool thread (gc)
                t.join(timeout=timeout)


class Monitor:
    """§3 step 6: periodically checks worker health and restarts dead
    workers (threads that terminated while the pool is active)."""
    def __init__(self, pool: WorkerPool, period: float = 0.5):
        self.pool = pool
        self.period = period
        self.restarts = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            time.sleep(self.period)
            if self.pool._stop.is_set():
                continue
            # restart toward the pool's *current* capacity target
            # (elastic resize moves it), never past it — a retired
            # thread is an intentional shrink, not a death, and the
            # spawn-locked reconcile re-checks the deficit per spawn
            # so a concurrent resize can't be double-counted
            n = self.pool._reconcile()
            self.restarts += n
            if n:
                self.pool.tel.instant("pool.restart", n=n,
                                      pool=self.pool.name)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if (self._thread.is_alive()
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=2.0)
