"""Elastic worker-fleet membership + chaos scenario harness; the port of
``repro/infra/fleet.py``.

DiPaCo's robustness claim (§3.4) is that training tolerates a fleet of
poorly connected, heterogeneous, preemptible workers.  This module is
the membership layer that makes the claim testable:

``WorkerProfile``
    Per-worker link/compute/preemption characteristics.  Bandwidth
    drives the bandwidth-aware fragment schedule (slow links ship
    small fragments first — ``TrainingService._shard_slots_locked``) and the
    per-leaf comm-dtype policy prices each link honestly; the
    preemption rate feeds the pool's per-task preemption injection.

``FleetController``
    Owns live membership on top of ``WorkerPool``/``Monitor``: spot
    workers ``join``/``leave`` mid-run, every change bumps a
    *membership epoch*, resizes each executor's quorum via
    ``resize_membership`` (a window already past the shrunk quorum
    drains immediately; evicted workers' in-flight stragglers fold as
    lagged, never double-count), cancels the departed workers' queued
    tasks, and persists a ``kind="fleet"`` row under the service's
    commit lock — so membership changes replay at the exact same point
    of the row order on resume, keeping kill-and-resume across an
    epoch change bit-exact.

``ChaosController``
    Deterministic scripted fleet events (kill 30% mid-phase, flapping
    joins, capacity collapse) against ``TrainingService.run``.
    Phase-boundary events fire between ``run(1)`` calls; ``when="mid"``
    events arm a checkpoint-row listener and fire after the first
    commit of the target phase lands — genuinely mid-window.  The same
    seed replays the same schedule.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass

import torch

from repro_torch.obs import NULL


@dataclass(frozen=True)
class WorkerProfile:
    """Static characteristics of one fleet worker (== one data shard).

    ``bandwidth`` is relative to a reference link of 1.0 — below it the
    service re-ranks the worker's fragment sends smallest-first.
    ``compute`` is a relative phase-compute speed (< 1.0 = straggler).
    ``preempt_rate`` is the per-task probability the worker is
    reclaimed mid-task (spot/backup pool tier)."""

    bandwidth: float = 1.0
    compute: float = 1.0
    preempt_rate: float = 0.0

    def __post_init__(self):
        if self.bandwidth <= 0 or self.compute <= 0:
            raise ValueError("bandwidth and compute must be positive")
        if not 0.0 <= self.preempt_rate < 1.0:
            raise ValueError("preempt_rate must be in [0, 1)")


class FleetController:
    """Live membership for a ``TrainingService``'s worker fleet.

    Membership is the set of *shards* contributing to executors and
    being pumped by the async scheduler.  All mutation happens under
    the service's commit lock, so the ``kind="fleet"`` row lands in
    the checkpoint row order exactly where the quorum change took
    effect — the property bit-exact resume through an epoch change
    rests on."""

    def __init__(self, service):
        self._svc = service
        self.epoch = 0
        self.events: list = []       # (epoch, action, shards) audit log

    # -- membership changes --------------------------------------------
    def leave(self, shards, *, reason: str = "preempt") -> list:
        """Evict workers from the fleet: quorums resize (windows they
        already fill drain immediately), their queued tasks are
        cancelled, their in-flight work may still fold as lagged."""
        svc = self._svc
        with svc._commit_lock:
            gone = sorted(set(int(s) for s in shards) & svc.members)
            if not gone:
                return []
            svc.members -= set(gone)
            self._commit_epoch_locked("leave", gone, reason=reason)
        gone_set = set(gone)
        dropped = svc.queue.cancel(
            lambda t: t.payload.get("shard_id") in gone_set)
        # a cancelled pending task never completes: clear its shard's
        # in-flight mark or a later rejoin would never be pumped again
        # (leased tasks stay — they finish and clear themselves);
        # run() waiters must also re-evaluate which shards they wait for
        with svc._clock_cv:
            for t in dropped:
                svc._inflight.discard(t.payload.get("shard_id"))
            svc._clock_cv.notify_all()
        svc._pump()
        return gone

    def join(self, shards) -> list:
        """(Re)admit workers: quorums grow back, the scheduler starts
        pumping them from wherever their phase clock stands."""
        svc = self._svc
        with svc._commit_lock:
            came = sorted(set(int(s) for s in shards)
                          & set(range(svc.num_shards)) - svc.members)
            if not came:
                return []
            svc.members |= set(came)
            self._commit_epoch_locked("join", came)
        svc._pump()
        return came

    def kill_fraction(self, frac: float, *, seed: int = 0) -> list:
        """Deterministically evict ``frac`` of the current members
        (round-to-nearest, at least one when frac > 0)."""
        svc = self._svc
        # membership changes land under the commit lock; sample from a
        # consistent snapshot, not a set another thread is resizing
        with svc._commit_lock:
            members = sorted(svc.members)
        n = min(len(members) - 1,
                max(1, round(frac * len(members))) if frac > 0 else 0)
        if n <= 0:
            return []
        rng = random.Random((seed, self.epoch, len(members)).__repr__())
        return self.leave(rng.sample(members, n))

    def set_capacity(self, num_workers: int) -> None:
        """Scale the thread pool (machines, not membership): the
        Monitor's restart target follows."""
        self._svc.pool.resize(num_workers)

    # -- internals ------------------------------------------------------
    def _commit_epoch_locked(self, action: str, shards: list,
                             **extra) -> None:
        svc = self._svc
        self.epoch += 1
        self.events.append((self.epoch, action, list(shards)))
        members = sorted(svc.members)
        svc.db.write(
            {"epoch": torch.tensor([self.epoch], dtype=torch.int32)},
            path_id=-1, phase=max(svc.clock.values(), default=0),
            step=self.epoch, kind="fleet",
            extra={"event": action, "shards": [int(s) for s in shards],
                   "members": [int(s) for s in members],
                   "epoch": int(self.epoch), **extra})
        # getattr: unit tests drive the controller with minimal
        # service fakes that predate the telemetry handle
        getattr(svc, "tel", NULL).instant(
            "fleet.epoch", epoch=int(self.epoch), action=action,
            shards=[int(s) for s in shards],
            members=[int(s) for s in members])
        svc.execs.resize_membership(members)

    def restore_row(self, row) -> None:
        """Replay one persisted ``kind="fleet"`` row (called by
        ``TrainingService._restore_from_db`` in row order)."""
        svc = self._svc
        members = set(int(s) for s in row.extra.get("members", []))
        # analysis: lockfree(resume replay is single-threaded; workers start after restore)
        svc.members = members
        self.epoch = int(row.extra.get("epoch", self.epoch + 1))
        self.events.append((self.epoch, row.extra.get("event", "?"),
                            [int(s) for s in row.extra.get("shards", [])]))
        svc.execs.resize_membership(sorted(members))


class ChaosController:
    """Scripted fleet-event scenarios against ``TrainingService.run``.

    ``events`` is a list of dicts::

        {"phase": 2, "action": "kill_frac", "frac": 0.3, "when": "mid"}
        {"phase": 3, "action": "leave", "shards": [1, 2]}
        {"phase": 4, "action": "join", "shards": [1]}
        {"phase": 5, "action": "capacity", "num_workers": 2}

    ``when="boundary"`` (default) fires before that phase's ``run(1)``;
    ``when="mid"`` arms a checkpoint listener and fires right after the
    first train-row commit of that phase — membership changes land
    while other members' windows are still accumulating."""

    def __init__(self, service, events=(), *, seed: int = 0):
        self._svc = service
        self.seed = int(seed)
        self.events = [dict(e) for e in events]
        self.fired: list = []
        self._threads: list = []

    def run(self, phases: int, *, tau=None, timeout=None) -> dict:
        """Advance the fleet ``phases`` phases, firing scripted events.
        Returns the final ``run`` metrics plus the chaos audit trail."""
        svc = self._svc
        out: dict = {}
        with svc._commit_lock:
            base = min((svc.clock[s] for s in sorted(svc.members)),
                       default=0)
        for p in range(phases):
            phase = base + p
            for ev in self.events:
                if ev.get("phase") != phase:
                    continue
                if ev.get("when", "boundary") == "mid":
                    self._arm_mid(ev, phase)
                else:
                    self._apply(ev)
            out = svc.run(1, tau=tau, timeout=timeout)
            for t in self._threads:
                t.join(timeout=10.0)
            self._threads = []
        out["chaos_events"] = list(self.fired)
        out["fleet_epoch"] = svc.fleet.epoch
        with svc._commit_lock:
            out["members"] = sorted(svc.members)
        return out

    # -- internals ------------------------------------------------------
    def _apply(self, ev: dict) -> None:
        svc = self._svc
        act = ev["action"]
        if act == "leave":
            got = svc.fleet.leave(ev["shards"])
        elif act == "join":
            got = svc.fleet.join(ev["shards"])
        elif act == "kill_frac":
            got = svc.fleet.kill_fraction(
                ev["frac"], seed=ev.get("seed", self.seed))
        elif act == "capacity":
            svc.fleet.set_capacity(ev["num_workers"])
            got = ev["num_workers"]
        else:
            raise ValueError(f"unknown chaos action {act!r}")
        self.fired.append({"action": act, "applied": got,
                           "phase_clock": dict(svc.clock)})
        getattr(svc, "tel", NULL).instant(
            "fleet.chaos", action=act,
            applied=got if isinstance(got, (int, list)) else list(got))

    def _arm_mid(self, ev: dict, phase: int) -> None:
        """Fire ``ev`` right after the first train-row commit of
        ``phase`` lands.  The listener (called with the committer's
        locks held) only sets an event; a side thread applies the
        change through the normal lock order."""
        svc = self._svc
        trig = threading.Event()

        def on_row(row):
            if row.kind == "train" and row.phase >= phase:
                trig.set()

        svc.db.add_listener(on_row)

        def fire():
            try:
                trig.wait(timeout=svc.phase_timeout)
                self._apply(ev)
            finally:
                svc.db.remove_listener(on_row)

        t = threading.Thread(target=fire, daemon=True,
                             name=f"chaos-mid-{phase}")
        t.start()
        self._threads.append(t)
