"""Multi-process serving fleet: a path-affinity front door over N engines;
the port of ``repro/serving/fleet.py``.

DiPaCo's inference story (paper §2.4) is that each request executes
exactly one path, so serving scales *horizontally*: put a fleet of
:class:`ContinuousBatchingEngine` processes behind one front door and
route each request to an engine with its path's traffic resident.  The
front door owns three decisions, all host-side and cheap:

* **path affinity** — a consistent (rendezvous / highest-random-weight)
  ranking of engines per path island.  A path's requests concentrate on
  its top-ranked members, so that engine's slot arenas, captured tick
  and cross-request prefix cache stay hot for that path's
  traffic; raising a path's replica count only *adds* the next-ranked
  engine, it never reshuffles the existing assignment.
* **autoscaled replicas** — per-path replica counts are recomputed from
  the front door's own outstanding-request ledger plus the per-path
  backpressure counts the engine schedulers report
  (``SchedulerStats.starved_by_path``): a path whose queue outgrows one
  engine's slot budget fans out to more members, and decays back to one
  when the burst passes.
* **dispatch** — among a path's current members, least-outstanding wins
  (requests are pre-routed: ``Request.path`` is stamped by the front
  door, and engine schedulers honor it instead of re-routing).

Two backends share the front-door logic:

* ``backend="inproc"`` — N engines in this process, driven on a
  deterministic simulated clock (tests, CI).
* ``backend="process"`` — N OS processes (spawn context: a CUDA context
  does not survive a fork), each constructing its own registry handle
  and engine on the registry's device from a picklable spec (the base
  weights rebuilt from ``seed``) and following the cross-process ``SERVING``
  pointer.  A ``registry.promote`` by *any* process therefore hot-swaps
  every fleet member: each child polls the pointer file every engine
  tick.  The front door itself launches nothing on a device.  A member
  that fails ships its traceback, and the front door raises it; one
  that dies without a word is found by its exit code.

Priority classes, preemption and prefix caching live in the engine
(serving/engine.py, serving/scheduler.py, serving/cache.py); the fleet
only transports them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing as mp
import queue as queue_mod
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import as_telemetry

from .engine import ContinuousBatchingEngine, EngineOptions, \
    FinishedRequest
from .scheduler import Request, prefix_hash_router

# EngineOptions fields forwarded to fleet members.  route_fn/router are
# deliberately excluded (the front door pre-routes; engines must not
# second-guess the affinity assignment), as are telemetry handles
# (process-local) and reroute_every (needs a router).
_CHILD_OPTION_FIELDS = ("cache_len", "swap_policy", "slots_per_path",
                        "stacked", "bucketed_prefill", "prefill_buckets",
                        "prefix_cache", "preemption", "cuda_graph")


def _worker_stats(eng) -> dict:
    st = eng.scheduler.stats
    pc = eng.prefix_cache
    return {
        "version": eng.version,
        "ticks": eng.ticks,
        "in_flight": len(eng.in_flight),
        "starved_by_path": dict(st.starved_by_path),
        "preemptions": st.preemptions,
        "prefix_hits": (pc.hits + pc.extensions) if pc else 0,
        "prefix_misses": pc.misses if pc else 0,
    }


def _fleet_worker(wid: int, spec: dict, inbox, outbox) -> None:
    """Engine-process main loop (spawn target — must stay top-level).

    Builds its own registry handle on the shared ``root`` (so promotes
    made by any process land via the SERVING pointer poll inside every
    ``step``) and streams :class:`FinishedRequest` batches plus
    heartbeat stats back to the front door.  An engine that replays its
    tick from a CUDA graph always warms up (the capture happens there).
    """
    try:
        from repro_torch.deploy.registry import DeploymentRegistry

        reg = DeploymentRegistry(spec["cfg"], spec["dcfg"], spec["root"],
                                 seed=spec["seed"], device=spec["device"])
        opts = EngineOptions(registry=reg, **spec["engine"])
        eng = ContinuousBatchingEngine(spec["cfg"], options=opts)
        if spec.get("warmup") or eng.cuda_graph:
            eng.warmup()
        outbox.put(("ready", wid, eng.version))
        # absolute CLOCK_MONOTONIC timestamps: comparable across the
        # fleet's processes, so the front door can rebase arrivals into
        # the same timebase and latency/TTFT stay honest end to end
        stopping = False
        beat = 0
        while True:
            try:
                while True:
                    kind, payload = inbox.get_nowait()
                    if kind == "stop":
                        stopping = True
                    elif kind == "req":
                        eng.submit(payload)
            except queue_mod.Empty:
                pass
            if eng.idle:
                if stopping:
                    break
                # idle duty cycle: still tick (the registry poll lives
                # inside step, and a promote must land promptly), but
                # don't spin the core
                time.sleep(1e-3)
            fins = eng.step(now=time.perf_counter())
            # wall-clock re-stamp, mirroring the realtime serve_trace
            # driver: the tick's device compute belongs in TTFT
            now = time.perf_counter()
            new_rids = {st.req.rid for st in eng._new_first}
            for st in eng._new_first:
                st.first_token_at = now
            for f in fins:
                f.finished_at = now
                if f.rid in new_rids:
                    f.first_token_at = now
            if fins:
                outbox.put(("fin", wid, fins))
            beat += 1
            if fins or beat % 16 == 0:
                outbox.put(("beat", wid, _worker_stats(eng)))
        outbox.put(("done", wid, _worker_stats(eng)))
    except Exception:  # ship the traceback; the parent raises it
        import traceback
        outbox.put(("err", wid, traceback.format_exc()))


class ServingFleet:
    """Path-affinity front door over ``size`` serving engines.

    Requires ``options.registry``: fleet members rendezvous on the
    registry's cross-process SERVING pointer (that is what makes a
    single ``promote`` hot-swap every member).  Routing uses
    ``options.route_fn`` when given, else the deterministic
    prompt-hash router — feature-based routers hold model state and are
    not transported across the process boundary.

    Process members serve on the registry's device and rebuild the
    deployment's base weights from ``seed``, so the registry must have
    been built from that seed too.
    """

    def __init__(self, cfg, *, size: int,
                 options: Optional[EngineOptions] = None,
                 backend: str = "process", seed: int = 0,
                 warmup: bool = False, rebalance_every: int = 64,
                 telemetry=None):
        if size < 1:
            raise ValueError(f"fleet size must be >= 1, got {size}")
        if backend not in ("process", "inproc"):
            raise ValueError(f"backend must be 'process' or 'inproc', "
                             f"got {backend!r}")
        opts = options if options is not None else EngineOptions()
        if opts.registry is None:
            raise ValueError(
                "ServingFleet requires options.registry — members "
                "follow the cross-process SERVING pointer")
        self.cfg = cfg
        self.size = size
        self.backend = backend
        self.options = opts
        self.registry = opts.registry
        self.tel = as_telemetry(telemetry if telemetry is not None
                                else opts.telemetry)
        self.num_paths = self.registry.num_paths
        self.route_fn = (opts.route_fn if opts.route_fn is not None
                         else prefix_hash_router(self.num_paths))
        self.slots_per_path = opts.slots_per_path
        self.rebalance_every = rebalance_every
        # per-path replica counts (autoscaled; start minimal)
        self.replicas: Dict[int, int] = {p: 1
                                         for p in range(self.num_paths)}
        # front-door ledger: dispatched-but-unfinished per engine/path
        self._outstanding = [0] * size
        self._outstanding_by_path = {p: 0 for p in range(self.num_paths)}
        # backpressure accumulated since the last rebalance, and the
        # last starved_by_path snapshot seen per member (delta source)
        self._starved_since = {p: 0 for p in range(self.num_paths)}
        self._starved_seen: List[dict] = [{} for _ in range(size)]
        self._rid_engine: Dict[int, tuple] = {}
        self._versions: List[Optional[int]] = [None] * size
        self._worker_stats: List[dict] = [{} for _ in range(size)]
        self._fin_buffer: List[FinishedRequest] = []
        self._procs: list = []
        self._closing = False
        self.stats = {"routed": 0, "rebalances": 0}
        if backend == "inproc":
            child = dataclasses.replace(
                opts, router=None, route_fn=None, feat_params=None)
            self.engines = [ContinuousBatchingEngine(cfg, options=child)
                            for _ in range(size)]
            if warmup:
                for e in self.engines:
                    e.warmup()
            self._versions = [e.version for e in self.engines]
            return
        ctx = mp.get_context("spawn")   # CUDA is not fork-safe
        self._inboxes = [ctx.Queue() for _ in range(size)]
        self._outbox = ctx.Queue()
        spec = {"cfg": cfg, "dcfg": self.registry.dcfg,
                "root": self.registry.root, "seed": seed,
                "device": str(self.registry.device), "warmup": warmup,
                "engine": {f: getattr(opts, f)
                           for f in _CHILD_OPTION_FIELDS}}
        self._procs = [
            ctx.Process(target=_fleet_worker, daemon=True,
                        args=(w, spec, self._inboxes[w], self._outbox))
            for w in range(size)]
        for pr in self._procs:
            pr.start()
        ready = 0
        deadline = time.monotonic() + 600.0
        try:
            while ready < size:   # block until every member serves
                try:
                    kind, wid, payload = self._outbox.get(timeout=1.0)
                except queue_mod.Empty:
                    self._check_alive()
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{size - ready} fleet members not ready "
                            f"after 600 s")
                    continue
                if kind == "err":
                    raise RuntimeError(f"fleet worker {wid} failed to "
                                       f"start:\n{payload}")
                if kind == "ready":
                    self._versions[wid] = payload
                    ready += 1
        except BaseException:
            self._terminate()
            raise

    # -- affinity + dispatch -------------------------------------------
    @staticmethod
    def _score(path: int, engine: int) -> int:
        h = hashlib.md5(f"{path}:{engine}".encode()).digest()
        return int.from_bytes(h[:8], "big")

    def members(self, path: int) -> List[int]:
        """Current members for ``path``: the top ``replicas[path]`` of
        the rendezvous ranking.  Consistent by construction — scaling a
        path up/down only appends/drops the lowest-ranked member."""
        ranked = sorted(range(self.size),
                        key=lambda e: self._score(path, e), reverse=True)
        return ranked[:self.replicas[path]]

    def submit(self, req: Request) -> int:
        """Route ``req`` to an engine and dispatch it; returns the
        member index chosen (pre-stamps ``req.path``)."""
        path = req.path if req.path is not None \
            else int(self.route_fn(req.prompt))
        req.path = path
        cand = self.members(path)
        engine = min(cand, key=lambda e: self._outstanding[e])
        self._outstanding[engine] += 1
        self._outstanding_by_path[path] += 1
        self._rid_engine[req.rid] = (engine, path)
        self.stats["routed"] += 1
        self.tel.instant("serve.route", rid=req.rid, path=path,
                         engine=engine, replicas=len(cand))
        if self.backend == "inproc":
            self.engines[engine].submit(req)
        else:
            self._inboxes[engine].put(("req", req))
        return engine

    def rebalance(self) -> None:
        """Recompute per-path replica counts from the front-door queue
        ledger plus per-path backpressure reported since the last
        rebalance.  One engine's slot budget is the per-replica
        capacity unit: a path with more live demand than one arena
        holds fans out to ceil(load / slots) members."""
        if self.backend == "inproc":
            self._harvest_inproc()
        for p in range(self.num_paths):
            load = self._outstanding_by_path[p] + self._starved_since[p]
            want = -(-load // max(1, self.slots_per_path))
            self.replicas[p] = max(1, min(self.size, want))
            self._starved_since[p] = 0
        self.stats["rebalances"] += 1
        self.tel.instant("serve.rebalance",
                         hot=max(self.replicas.values()),
                         paths=self.num_paths)

    # -- member feedback -----------------------------------------------
    def _merge_starved(self, wid: int, starved_by_path: dict) -> None:
        seen = self._starved_seen[wid]
        for p, n in starved_by_path.items():
            d = int(n) - int(seen.get(p, 0))
            if d > 0:
                self._starved_since[p] = \
                    self._starved_since.get(p, 0) + d
        self._starved_seen[wid] = dict(starved_by_path)

    def _harvest_inproc(self) -> None:
        for e, eng in enumerate(self.engines):
            self._merge_starved(e, eng.scheduler.stats.starved_by_path)
            self._versions[e] = eng.version
            self._worker_stats[e] = _worker_stats(eng)

    def _account(self, fins: List[FinishedRequest]) -> None:
        for f in fins:
            engine, path = self._rid_engine.pop(f.rid, (None, None))
            if engine is not None:
                self._outstanding[engine] -= 1
                self._outstanding_by_path[path] -= 1

    def _handle(self, kind: str, wid: int, payload) -> None:
        if kind == "fin":
            self._account(payload)
            self._fin_buffer.extend(payload)
        elif kind in ("beat", "done"):
            self._versions[wid] = payload["version"]
            self._worker_stats[wid] = payload
            self._merge_starved(wid, payload["starved_by_path"])
        elif kind == "ready":
            self._versions[wid] = payload
        elif kind == "err":
            raise RuntimeError(f"fleet worker {wid} died:\n{payload}")

    def _pump(self, block: bool = False, timeout: float = 0.05) -> None:
        """Drain member→front-door messages (process backend); a member
        that exited without reporting raises."""
        if self.backend == "inproc":
            return
        try:
            while True:
                msg = (self._outbox.get(timeout=timeout) if block
                       else self._outbox.get_nowait())
                block = False
                self._handle(*msg)
        except queue_mod.Empty:
            self._check_alive()

    def _check_alive(self) -> None:
        """Raise if a member exited while the fleet serves: with its
        traceback where it shipped one before exiting."""
        if self._closing:
            return
        dead = {w: pr.exitcode for w, pr in enumerate(self._procs)
                if pr.exitcode is not None}
        if not dead:
            return
        try:
            while True:
                self._handle(*self._outbox.get(timeout=1.0))
        except queue_mod.Empty:
            pass
        raise RuntimeError(f"fleet workers exited (worker: exit code): "
                           f"{dead}")

    def _drain_fins(self) -> List[FinishedRequest]:
        out, self._fin_buffer = self._fin_buffer, []
        return out

    # -- fleet-wide views ----------------------------------------------
    def versions(self) -> List[Optional[int]]:
        """Serving version per member (inproc: live; process: the last
        heartbeat each member sent)."""
        if self.backend == "inproc":
            return [e.version for e in self.engines]
        return list(self._versions)

    def wait_version(self, version: int, timeout: float = 120.0) -> None:
        """Block until every member serves ``version`` (after a
        ``registry.promote``).  Inproc members are ticked so their
        per-step registry poll runs; process members report via
        heartbeat."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.backend == "inproc":
                for e in self.engines:
                    if e.version != version:
                        e.step()
            else:
                self._pump(block=True, timeout=0.1)
            if all(v == version for v in self.versions()):
                return
        raise TimeoutError(
            f"fleet members still on {self.versions()} after "
            f"{timeout}s waiting for version {version}")

    def member_stats(self) -> List[dict]:
        if self.backend == "inproc":
            self._harvest_inproc()
        return [dict(s) for s in self._worker_stats]

    # -- drivers --------------------------------------------------------
    def serve_trace(self, trace: List[Request], *,
                    realtime: Optional[bool] = None,
                    tick_dt: float = 1e-3) -> List[FinishedRequest]:
        """Drive an arrival trace through the fleet to completion.

        Inproc default: deterministic simulated clock — every member
        ticks in lockstep and ``tick_dt`` advances per round (tests).
        Process backend is wall-clock only: arrivals are paced on
        ``time.perf_counter`` and completions stream back as members
        finish them.  Results are returned sorted by rid.
        """
        if realtime is None:
            realtime = self.backend == "process"
        if self.backend == "process" and not realtime:
            raise ValueError("process backend paces on the wall clock; "
                             "realtime=False needs backend='inproc'")
        trace = sorted(trace, key=lambda r: r.arrival)
        out: List[FinishedRequest] = []
        i = 0
        if self.backend == "inproc" and not realtime:
            now, ticks = 0.0, 0
            while i < len(trace) or not all(e.idle for e in self.engines):
                if all(e.idle for e in self.engines) and i < len(trace):
                    now = max(now, trace[i].arrival)
                while i < len(trace) and trace[i].arrival <= now:
                    self.submit(trace[i])
                    i += 1
                for e in self.engines:
                    fins = e.step(now=now)
                    self._account(fins)
                    out.extend(fins)
                now += tick_dt
                ticks += 1
                if ticks % self.rebalance_every == 0:
                    self.rebalance()
            return sorted(out, key=lambda f: f.rid)
        # wall-clock pacing (process backend, or realtime inproc)
        t0 = time.perf_counter()
        last_reb = t0
        while i < len(trace) or len(out) < len(trace):
            now = time.perf_counter() - t0
            while i < len(trace) and trace[i].arrival <= now:
                if self.backend == "process":
                    # rebase onto the shared monotonic clock so child
                    # engines' admitted/first-token/finished stamps are
                    # directly comparable to the arrival
                    trace[i].arrival += t0
                self.submit(trace[i])
                i += 1
            if self.backend == "inproc":
                for e in self.engines:
                    fins = e.step(now=time.perf_counter() - t0)
                    self._account(fins)
                    out.extend(fins)
            else:
                self._pump()
                out.extend(self._drain_fins())
            if time.perf_counter() - last_reb >= 0.2:
                self.rebalance()
                last_reb = time.perf_counter()
            if self.backend == "process":
                if i < len(trace):
                    time.sleep(min(1e-3, max(
                        0.0, trace[i].arrival
                        - (time.perf_counter() - t0))))
                elif len(out) < len(trace):
                    time.sleep(1e-3)
        if self.backend == "process":
            for f in out:   # back into trace-relative seconds
                f.arrival -= t0
                f.admitted_at -= t0
                f.finished_at -= t0
                if f.first_token_at:
                    f.first_token_at -= t0
        self.tel.flush()
        return sorted(out, key=lambda f: f.rid)

    # -- lifecycle ------------------------------------------------------
    def close(self, timeout: float = 120.0) -> None:
        """Stop every member (process backend: members finish their
        in-flight work, report final stats and exit)."""
        if self.backend == "inproc" or self._closing:
            return
        self._closing = True
        try:
            for ib in self._inboxes:
                ib.put(("stop", None))
            # drain while the members finish: a member blocks on exit
            # until its queued messages are read
            deadline = time.monotonic() + timeout
            while (any(pr.is_alive() for pr in self._procs)
                   and time.monotonic() < deadline):
                self._pump(block=True, timeout=0.1)
            self._pump()
        finally:
            self._terminate()

    def _terminate(self) -> None:
        """End every member still running (no process outlives the
        fleet)."""
        self._closing = True
        for pr in self._procs:
            if pr.is_alive():
                pr.terminate()
        for pr in self._procs:
            pr.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
