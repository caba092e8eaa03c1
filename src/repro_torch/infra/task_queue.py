"""Fault-tolerant task queue (paper §3.1-§3.2); the port's own copy of
``repro/infra/task_queue.py`` (stdlib only, line for line).

Producer-consumer with *leases*: a fetched task is leased to a worker;
if the worker dies or its lease expires the task returns to the queue
and is reassigned (the paper's preemption recovery).  The queue can
checkpoint itself (server-failure recovery).

A ``barrier`` primitive mirrors §3.2's multi-host synchronization: it
blocks until every registered participant has called with the same key.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Task:
    kind: str                   # "train" | "eval" | "outer"
    payload: dict
    task_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    attempts: int = 0


class TaskQueue:
    def __init__(self, *, lease_seconds: float = 30.0,
                 max_attempts: int = 5):
        self._lock = threading.Condition()
        self._pending: deque = deque()
        self._leased: dict = {}          # task_id -> (Task, deadline)
        self._done: dict = {}
        self._failed: dict = {}
        self.lease_seconds = lease_seconds
        self.max_attempts = max_attempts
        self._closed = False

    # -- producer ------------------------------------------------------
    def put(self, task: Task):
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._pending.append(task)
            self._lock.notify()

    def put_many(self, tasks):
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._pending.extend(tasks)
            self._lock.notify_all()

    # -- consumer ------------------------------------------------------
    def fetch(self, timeout: float | None = None):
        """Lease the next task; None if queue closed/empty at timeout."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while True:
                self._reap_expired_locked()
                if self._pending:
                    task = self._pending.popleft()
                    task.attempts += 1
                    self._leased[task.task_id] = (
                        task, time.time() + self.lease_seconds)
                    return task
                if self._closed:
                    return None
                wait = 0.05 if deadline is None else min(
                    0.05, deadline - time.time())
                if deadline is not None and time.time() >= deadline:
                    return None
                self._lock.wait(timeout=max(wait, 0.001))

    def complete(self, task_id: str, result=None):
        with self._lock:
            if task_id in self._leased:
                task, _ = self._leased.pop(task_id)
                self._done[task_id] = (task, result)
                self._lock.notify_all()

    def renew_lease(self, task_id: str) -> bool:
        """Heartbeat for long-running tasks: push the lease deadline out
        another ``lease_seconds`` so a slow-but-alive worker is not
        double-assigned (the service calls this before each inner-phase
        compute)."""
        with self._lock:
            if task_id not in self._leased:
                return False
            task, _ = self._leased[task_id]
            self._leased[task_id] = (task, time.time() + self.lease_seconds)
            return True

    def fail(self, task_id: str, err=None):
        """Worker died / raised: requeue unless attempts exhausted."""
        with self._lock:
            if task_id not in self._leased:
                return
            task, _ = self._leased.pop(task_id)
            if task.attempts >= self.max_attempts:
                self._failed[task_id] = (task, err)
            else:
                self._pending.appendleft(task)
            self._lock.notify_all()

    def cancel(self, predicate) -> list:
        """Drop pending tasks matching ``predicate(task)`` (a worker
        leaving the fleet takes its queued work with it) and return
        them — the caller needs to know which shards lost their queued
        work to clear its own in-flight bookkeeping.  Leased tasks are
        not touched — an in-flight execution is allowed to finish and
        fold as a lagged straggler."""
        with self._lock:
            keep: deque = deque()
            dropped: list = []
            for t in self._pending:
                if predicate(t):
                    dropped.append(t)
                else:
                    keep.append(t)
            self._pending = keep
            if dropped:
                self._lock.notify_all()
            return dropped

    def _reap_expired_locked(self):
        now = time.time()
        expired = [tid for tid, (_, dl) in self._leased.items() if dl < now]
        for tid in expired:
            task, _ = self._leased.pop(tid)
            if task.attempts >= self.max_attempts:
                self._failed[tid] = (task, "lease expired")
            else:
                self._pending.appendleft(task)

    # -- introspection / lifecycle --------------------------------------
    def join(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while self._pending or self._leased:
                self._reap_expired_locked()
                if deadline is not None and time.time() >= deadline:
                    return False
                self._lock.wait(timeout=0.05)
            return True

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def stats(self) -> dict:
        with self._lock:
            return {"pending": len(self._pending),
                    "leased": len(self._leased),
                    "done": len(self._done),
                    "failed": len(self._failed)}

    def results(self) -> dict:
        with self._lock:
            return {tid: r for tid, (t, r) in self._done.items()}

    # -- persistence (server restart recovery) --------------------------
    def snapshot(self) -> str:
        with self._lock:
            state = {
                "pending": [(t.kind, t.payload, t.task_id, t.attempts)
                            for t in self._pending],
                "leased": [(t.kind, t.payload, t.task_id, t.attempts)
                           for t, _ in self._leased.values()],
            }
        return json.dumps(state)

    @classmethod
    def restore(cls, blob: str, **kw) -> "TaskQueue":
        q = cls(**kw)
        state = json.loads(blob)
        for kind, payload, tid, att in state["pending"] + state["leased"]:
            q.put(Task(kind=kind, payload=payload, task_id=tid,
                       attempts=att))
        return q


class Barrier:
    """§3.2: blocks until all ``n`` participants call with the same key."""
    def __init__(self, n: int):
        self.n = n
        self._lock = threading.Condition()
        self._counts: dict = {}

    def wait(self, key: str, timeout: float = 30.0) -> bool:
        deadline = time.time() + timeout
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._lock.notify_all()
            while self._counts[key] % self.n != 0:
                if time.time() >= deadline:
                    return False
                self._lock.wait(timeout=0.05)
            return True
