"""Always-on asynchronous phase-pipelined DiPaCo training service (§3);
the port of ``repro/infra/service.py``.

The paper's central systems claim (Fig. 6-7) is that DiPaCo trains as a
resilient *service*: paths report deltas whenever they finish, sharded
outer executors advance per-module, and worker death never stalls the
run.  ``TrainingService`` realises that claim:

 * one long-lived ``WorkerPool`` + ``Monitor`` + ``TaskQueue`` own the
   whole run — no per-phase pool spin-up, no global ``queue.join()``
   barrier;
 * per-path phase clocks: a worker finishing phase t for its shard
   immediately snapshots its *current* module-store view and enqueues
   its own phase t+1 task, bounded by a ``max_phase_lag`` staleness
   window.  ``max_phase_lag=0`` degenerates to the synchronous barrier
   and is bit-compatible with the legacy round-based trainer;
 * per-module executors advance independently: each applies its
   Nesterov update the moment its quorum for phase t lands, even while
   other modules are still accumulating phase t-1
   (infra/outer_executor.py);
 * the ``CheckpointDB`` is the recovery substrate: train deltas, inner
   optimizer state, phase-start snapshots and per-module outer state
   (params + momentum + consumed contribution keys) all persist, and
   ``TrainingService.resume`` reconstructs the exact in-memory state —
   store, momenta, per-path clocks, in-flight snapshots, *partial
   accumulation windows* (by replaying unconsumed train deltas) — so a
   killed process continues bit-compatibly.

Commit protocol: checkpoint-row append order == executor accumulation
order (both happen under ``_commit_lock``), which is what makes the
resume replay order-faithful, and hence bit-exact, even though float
accumulation is order-sensitive.

In the port the module store, the workers' copies, the AdamW states and
the executors' windows live on ``device`` (default ``"cuda"``); the DB
is host-side and its rows move trees across (``infra/ckpt_db.py``
counts those moves).  A phase is ``tau`` steps of ``value_and_grad`` and
the in-place AdamW update on a copy of the phase-start snapshot, so every
attempt of a task starts from the snapshot and the last committed AdamW
state.  The pool's threads share the device's default stream.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.core.dipaco import PhaseMetrics
from repro_torch.core.fragments import (COMM_DTYPES, fragment_send_slot,
                                        quantize_with_feedback,
                                        resolve_comm_dtype)
from repro_torch.core.module_store import ModuleStore
from repro_torch.core.partition import make_partition
from repro_torch.data.loader import ShardLoader, phase_batches
from repro_torch.data.sharder import PreShardedDataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig, ModelConfig
from repro_torch.models.params import param_axes, tree_map
from repro_torch.obs import MetricRegistry, as_telemetry
from repro_torch.optim import adamw_init, adamw_update_, cosine_schedule
from .ckpt_db import CheckpointDB, load_tree
from .fleet import FleetController
from .outer_executor import ShardedOuterExecutors
from .transport import make_transport
from .task_queue import Task, TaskQueue
from .worker_pool import Monitor, WorkerPool


class PhaseTimeoutError(RuntimeError):
    """Raised when a phase target is not reached within the timeout —
    a real exception, unlike the ``assert`` it replaces, so it survives
    ``python -O``."""


class TrainingService:
    def __init__(self, cfg: ModelConfig, dcfg: DiPaCoConfig,
                 dataset: PreShardedDataset, *, ckpt_root: str,
                 base_params=None, batch_size: int = 8,
                 peak_lr: float = 4e-4, warmup: int = 100,
                 total_steps: int = 10_000, num_workers: int = 4,
                 preempt_prob: float = 0.0, seed: int = 0,
                 max_phase_lag: int = 0, phase_timeout: float = 600.0,
                 lease_seconds: float = 120.0,
                 monitor_period: float = 0.05, max_attempts: int = 50,
                 ckpt_retention: int | None = None, profiles=None,
                 resume: bool = False, telemetry=None, device="cuda"):
        # unified telemetry plane (repro.obs): spans/events into a
        # crash-safe trace + the metric registry that now owns the
        # comm accounting.  None -> shared no-op handle, but the
        # registry always exists so comm stats work untraced.
        self.tel = as_telemetry(telemetry)
        self.metrics = (self.tel.metrics if self.tel.metrics is not None
                        else MetricRegistry())
        self.cfg, self.dcfg = cfg, dcfg
        self.partition = make_partition(dcfg, cfg.pattern_repeats)
        P = self.partition.num_paths
        W = dataset.num_shards
        if not (W % P == 0 or P == 1):
            raise ValueError(f"num_shards {W} not a multiple of paths {P}")
        self.num_shards = W
        self.worker_paths = np.arange(W) % P
        if base_params is None:
            base_params = api.init_model(cfg, seed=seed, device=device)
        else:
            # the trainer's device is where it computes: the store, the
            # workers' copies and the executors' state live there
            dev = resolve_device(device)
            base_params = pytree.tree_map(lambda x: x.to(dev), base_params)
        self.device = pytree.leaves(base_params)[0].device
        self.axes = axes = param_axes(cfg)
        self.store = ModuleStore(base_params, axes, self.partition)
        alphas = dataset.alphas() if dcfg.loss_reweigh else \
            np.ones(W) / W
        if ckpt_retention is None:
            # replay-safety: retention must cover the staleness window
            # plus the straggler fold depth (see README)
            ckpt_retention = max(8, 4 * (max_phase_lag + 2))
        self.db = CheckpointDB(ckpt_root, max_rows_per_path=ckpt_retention)
        if dcfg.comm_dtype not in COMM_DTYPES:
            raise ValueError(f"comm_dtype {dcfg.comm_dtype!r} not in "
                             f"{COMM_DTYPES}")
        # elastic fleet: which shards currently contribute + get pumped
        # (FleetController mutates this under _commit_lock)
        self.members: set = set(range(W))
        # per-worker link/compute/preemption profiles (infra/fleet.py);
        # {} = homogeneous reference fleet, bit-identical legacy paths
        self.profiles = {int(s): p for s, p in (profiles or {}).items()}
        self.execs = ShardedOuterExecutors(
            self.store, self.partition, self.worker_paths, alphas,
            lr=dcfg.outer_lr, momentum=dcfg.outer_momentum,
            nesterov=dcfg.outer_nesterov, rescale=dcfg.grad_norm_rescale,
            quorum=dcfg.async_quorum, ckpt_db=self.db,
            fragments=dcfg.outer_fragments)
        # streaming fragment-wise outer sync (core/fragments.py): every
        # report is split into fragments; slot-0 fragments fold at the
        # commit, later slots stay *in flight* — parked here — while
        # the shard already runs its next phase, and fold at the
        # shard's next commit (or at a run/run_phase flush point,
        # recorded as a kind="flush" row so resume replays the exact
        # fold order).
        # wire dtype: the "uniform" policy keeps the plain dtype string
        # (bit-identical legacy path); "leafwise" resolves a per-leaf
        # list over the path-delta template (fp32 norms/embeddings,
        # int4 large matmuls — core.fragments.leaf_comm_dtypes)
        self._base_dtype = dcfg.comm_dtype
        self._comm_policy = dcfg.comm_dtype_policy
        self._comm_dtype = resolve_comm_dtype(
            dcfg.comm_dtype_policy, dcfg.comm_dtype,
            self.store.assemble(int(self.worker_paths[0])))
        self._stagger = dcfg.fragment_stagger
        # bandwidth-aware send schedule: per-shard slot tables (slow
        # links ship small fragments first), lazily built from profiles
        self._slot_cache: dict = {}
        # delta transport: "inproc" passes the wire tree by reference,
        # "mesh" ships the encoded payload across a device boundary
        # (infra/transport.py) — fold values are bit-identical either
        # way, so resume replay (which bypasses the transport) works
        # across backends.  transport_retries/transport_faults wrap it
        # in the retry/backoff/fault-injection chaos layer.  On the CPU
        # the mesh transport's one device is the service's own.
        self.transport = make_transport(
            dcfg.transport, comm_dtype=self._comm_dtype,
            devices=[self.device] if self.device.type != "cuda" else None,
            retries=dcfg.transport_retries, faults=dcfg.transport_faults,
            telemetry=self.tel)
        self._pending: dict = {i: [] for i in range(W)}   # s -> [(ph, f)]
        self._pending_payload: dict = {}                  # (s, ph) -> wire
        self._pending_count: dict = {}                    # (s, ph) -> refs
        self._qresid: dict = {i: None for i in range(W)}  # error feedback
        # comm accounting lives in the registry: one histogram whose
        # count/sum/max are the legacy sends/total/peak trio.  Handles
        # are cached so hot-path recording under _commit_lock never
        # takes the registry lock (thread-local cells, repro.obs).
        self._m_send_bytes = self.metrics.histogram("train.comm.send_bytes")
        # what the same sends would have shipped at fp32 (comm_stats)
        self._fp32_bytes = 0
        self._m_phase_wall = self.metrics.histogram("train.phase.wall_s")
        self.loaders = [ShardLoader(s, batch_size, seed=seed + i)
                        for i, s in enumerate(dataset.shards)]
        self.opt_states: dict = {i: None for i in range(W)}
        self.lr = lambda t: cosine_schedule(
            t, peak_lr=peak_lr, warmup=warmup, total_steps=total_steps)
        self.max_phase_lag = max_phase_lag
        self.phase_timeout = phase_timeout
        self.losses: dict = {}
        # barrier-mode counters (legacy run_phase wrapper)
        self.phase = 0
        self.step = 0
        # async per-path phase clocks
        self.clock = {i: 0 for i in range(W)}
        self.max_observed_lag = 0
        self._snapshots: dict = {}       # shard -> (phase, params)
        self._inflight: set = set()
        self._phase_done: set = set()    # (shard, phase) committed
        self._target = 0
        self._tau = dcfg.inner_steps
        # serializes db-row append + executor accumulation + clock
        # advance: row order == accumulation order -> replayable
        self._commit_lock = threading.Lock()
        self._clock_cv = threading.Condition()
        self.queue = TaskQueue(lease_seconds=lease_seconds,
                               max_attempts=max_attempts)
        # the pool handler must not hold a strong reference to the
        # service: worker threads are gc roots, so a strong ref would
        # keep a dropped service (and its threads) alive forever
        wself = weakref.ref(self)

        def _pool_handler(task, _w=wself):
            s = _w()
            return None if s is None else s._handle(task)

        preempt_for = None
        if self.profiles:
            # heterogeneous preemption: spot-tier shards die more often
            # (same weakref discipline as the handler)
            def preempt_for(task, _w=wself):
                s = _w()
                if s is None:
                    return 0.0
                prof = s.profiles.get(task.payload.get("shard_id"))
                return (prof.preempt_rate if prof is not None
                        else s.pool.preempt_prob)

        self.pool = WorkerPool(self.queue, _pool_handler,
                               num_workers=num_workers,
                               preempt_prob=preempt_prob,
                               preempt_for=preempt_for, seed=seed,
                               name="svc", telemetry=self.tel)
        self.monitor = Monitor(self.pool, period=monitor_period)
        self.fleet = FleetController(self)
        self._started = False
        if resume:
            self._restore_from_db()

    # ------------------------------------------------------------------
    @classmethod
    def resume(cls, cfg, dcfg, dataset, *, ckpt_root, **kw):
        """Reconstruct a killed service from its checkpoint root.  Must
        be called with the same constructor arguments as the original
        run (the DB stores deltas and optimizer state, not the model
        config or the base initialization)."""
        return cls(cfg, dcfg, dataset, ckpt_root=ckpt_root, resume=True,
                   **kw)

    # -- comm accounting (registry-backed) -----------------------------
    def _comm_summary(self) -> dict:
        """The comm numbers ``run()`` reports, rebuilt from the
        ``train.comm.send_bytes`` histogram (count == sends,
        sum == total bytes, max == peak send) plus the transport's
        ``retry_bytes`` — previously tracked but never surfaced."""
        snap = self.metrics.snapshot("train.comm.send_bytes")
        vals = snap.get("train.comm.send_bytes", {}).get("values", {})
        h = vals.get("", {"count": 0, "sum": 0.0, "max": 0})
        return {"peak_sync_bytes": int(h["max"]),
                "total_comm_bytes": int(h["sum"]),
                "sends": int(h["count"]),
                "retry_bytes": int(
                    dict(self.transport.stats).get("retry_bytes", 0))}

    def comm_stats(self) -> dict:
        """``run()['comm']`` plus ``fp32_bytes``, what the same sends
        would have shipped uncompressed, and the ratio of the two."""
        with self._commit_lock:
            out = self._comm_summary()
            fp32 = self._fp32_bytes
        out["fp32_bytes"] = fp32
        out["wire_over_fp32"] = out["total_comm_bytes"] / max(fp32, 1)
        return out

    def reset_comm_stats(self) -> None:
        """Zero the comm metrics (e.g. between warmup and measurement)."""
        self.metrics.reset("train.comm.")
        with self._commit_lock:
            self._fp32_bytes = 0

    # ------------------------------------------------------------------
    def _phase_fn(self, params0, opt0, batches, lrs):
        """``tau`` inner steps (the reference's ``lax.scan``): each a
        ``value_and_grad`` and the in-place AdamW update, on copies of
        the phase-start weights and AdamW state, which stay as they were
        for a retry of the task."""
        params = tree_map(torch.clone, params0)
        opt = tree_map(torch.clone, opt0)
        losses = []
        for k in range(batches.shape[0]):
            loss, _, grads = value_and_grad(params, self.cfg,
                                            {"tokens": batches[k]})
            adamw_update_(grads, opt, params, lr=lrs[k])
            del grads
            losses.append(loss)
        return params, opt, torch.stack(losses)

    # ------------------------------------------------------------------
    def _ensure_started(self):
        if not self._started:
            self._started = True
            self.pool.start()
            self.monitor.start()

    def shutdown(self):
        if getattr(self, "_shut", False):
            return
        self._shut = True
        self.monitor.stop()
        self.queue.close()
        self.pool.stop()
        self.tel.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def __del__(self):
        # services hold a worker pool + monitor; stop them when the
        # last reference drops so callers that never call shutdown()
        # (the legacy trainer pattern) don't leak polling threads
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    # ------------------------------------------------------------------
    def _handle(self, task: Task):
        p = task.payload
        shard, tau = p["shard_id"], p["tau"]
        t, start_step = p["phase"], p["start_step"]
        # analysis: lockfree(stale fast-path; recheck under _commit_lock below)
        if (shard, t) in self._phase_done:
            return {"shard": shard, "stale": True}   # retried, already done
        snap = self._snapshots.get(shard)
        if snap is None or snap[0] != t:
            return {"shard": shard, "stale": True}   # superseded retry
        # phase-start snapshot: every attempt of (shard, t) starts from
        # the exact theta the task was issued with, even if executors
        # updated modules since (Algorithm 1 line 4 + idempotence)
        params0 = snap[1]
        # analysis: lockfree(per-shard slot; only this shard's task touches it between commits)
        opt = self.opt_states[shard]
        if opt is None:
            opt = adamw_init(params0)
        # deterministic batches keyed by (shard, phase) — identical to
        # the vectorized trainer's schedule, recomputable after any
        # preemption
        t_start = time.perf_counter()
        with self.tel.span("train.phase", shard=shard, phase=t) as sp:
            batches = torch.as_tensor(phase_batches(
                self.loaders[shard].tokens, self.loaders[shard].batch_size,
                tau, shard, t), device=self.device)
            lrs = torch.stack([self.lr(start_step + k)
                               for k in range(tau)]).to(self.device)
            self.queue.renew_lease(task.task_id)
            params, opt, losses = self._phase_fn(params0, opt, batches, lrs)
            delta = pytree.tree_map(lambda a, b: a.float() - b.float(),
                                    params0, params)
            del params
            loss = float(losses.float().cpu().numpy().mean())
            sp.set(loss=loss)
            prof = self.profiles.get(shard)
            if prof is not None and prof.compute < 1.0:
                # heterogeneous compute: a slow machine's phase takes
                # proportionally longer — real straggler pressure for
                # the staleness window and the lag metrics
                time.sleep(min(0.05 * (1.0 / prof.compute - 1.0), 0.5))
        self._m_phase_wall.observe(time.perf_counter() - t_start,
                                   shard=shard)
        with self._commit_lock:
            # analysis: lockfree(adds happen in _complete, whose only caller holds _commit_lock too)
            if (shard, t) in self._phase_done:
                return {"shard": shard, "stale": True}  # lost a retry race
            # wire coding: quantize the outer delta (symmetric int8/int4
            # per-leaf scales); the quantization error stays worker-side
            # as an error-feedback residual added to the next phase's
            # delta.  The *wire* payload is what persists and what the
            # executors fold — the resume replay is therefore exact.
            wire, payload = delta, delta
            prev_resid = self._qresid[shard]
            if self._comm_dtype != "fp32":
                wire, resid, payload = quantize_with_feedback(
                    delta, self._qresid[shard], self._comm_dtype,
                    return_payload=True)
                self._qresid[shard] = resid
                self.db.write(resid, path_id=shard, phase=t,
                              step=start_step + tau, kind="qres")
            # the transport hop: inproc returns ``wire`` by reference,
            # mesh ships the encoded ``payload`` across a device
            # boundary and decodes it back to the same bits
            try:
                with self.tel.span("train.fragment_send", shard=shard,
                                   phase=t):
                    wire = self.transport.ship(shard, wire, payload,
                                               phase=t)
            except Exception:
                # retry exhaustion (TransportError): nothing was
                # delivered or recorded as train state — roll the
                # error-feedback residual back so the task's re-run
                # quantizes from the exact pre-send state (the orphan
                # qres row is ignored by resume for the same reason)
                self._qresid[shard] = prev_resid
                raise
            # the artifacts the paper ships via GFS: the delta (consumed
            # online by executors + the resume replay) and the inner
            # optimizer state (resume only)
            self.db.write(wire, path_id=shard, phase=t,
                          step=start_step + tau, kind="train",
                          extra={"loss": loss,
                                 "comm_dtype": self._base_dtype,
                                 "comm_policy": self._comm_policy,
                                 "comm_bytes": self._report_bytes(shard)})
            self.db.write(opt, path_id=shard, phase=t,
                          step=start_step + tau, kind="opt")
            self.opt_states[shard] = opt
            self.losses[(t, shard)] = loss
            dup = bool(getattr(self.transport, "last", {}).get("dup"))
            self._ingest_locked(shard, t, wire, dup_replay=dup)
            self._complete(shard, t)
        return {"shard": shard, "loss": loss}

    # -- streaming fragment hand-off -----------------------------------
    def _report_bytes(self, shard: int) -> int:
        return sum(self.execs.frag_bytes(shard, f, self._base_dtype,
                                         policy=self._comm_policy)
                   for f in range(self.execs.fragments))

    def _shard_slots_locked(self, shard: int) -> list:
        """Per-fragment send slots for this shard's link profile.  The
        reference link (no profile, or bandwidth >= 1.0) keeps the
        canonical ``fragment_send_slot`` schedule exactly — bit-
        identical to the homogeneous fleet; a slow link re-ranks
        fragments by ascending wire bytes before the same slot formula
        so its cheap fragments drain first and the heavy ones ride the
        in-flight tail."""
        slots = self._slot_cache.get(shard)
        if slots is None:
            K = self.execs.fragments
            prof = self.profiles.get(shard)
            ranks = list(range(K))
            if prof is not None and prof.bandwidth < 1.0:
                sizes = [self.execs.frag_bytes(
                    shard, f, self._base_dtype, policy=self._comm_policy)
                    for f in range(K)]
                order = sorted(range(K), key=lambda f: (sizes[f], f))
                ranks = [0] * K
                for r, f in enumerate(order):
                    ranks[f] = r
            slots = [fragment_send_slot(ranks[f], self._stagger, K)
                     for f in range(K)]
            self._slot_cache[shard] = slots
        return slots

    def _ingest_locked(self, shard: int, t: int, wire,
                       record_stats: bool = True,
                       dup_replay: bool = False) -> None:
        """Hand one report off to the executors on the fragment send
        schedule: the shard's previous in-flight fragments are now due
        (its next phase has begun), slot-0 fragments of this report
        fold immediately, later slots are parked in flight.  Each slot
        is one simulated send instant for the comms accounting.
        ``dup_replay`` re-delivers the slot-0 fold once more (a
        transport duplicate) — the executors' ``(worker, tag)`` dedup
        makes it a strict no-op, keeping chaos runs bit-exact."""
        self._flush_shard_locked(shard)
        K = self.execs.fragments
        send_slot = self._shard_slots_locked(shard)
        slots: dict = {}
        for f in range(K):
            slots.setdefault(send_slot[f], []).append(f)
        for slot in sorted(slots):
            frags = slots[slot]
            if record_stats:
                b = sum(self.execs.frag_bytes(shard, f, self._base_dtype,
                                              policy=self._comm_policy)
                        for f in frags)
                # one send instant: count/sum/max of this histogram
                # are the legacy sends/total/peak comm numbers
                self._m_send_bytes.observe(b)
                self._fp32_bytes += sum(self.execs.frag_bytes(shard, f)
                                        for f in frags)
            if slot == 0:
                # one call folds the whole slot: the delta is sliced
                # and flattened once per executor, not once per fragment
                self.execs.accumulate(shard, wire, phase=t, fragment=frags)
                if dup_replay:
                    # the duplicate of this send instant: every key is
                    # already in the window's seen set, so nothing folds
                    self.execs.accumulate(shard, wire, phase=t,
                                          fragment=frags)
            else:
                for f in frags:
                    self._pending[shard].append((t, f))
                    self._pending_count[(shard, t)] = \
                        self._pending_count.get((shard, t), 0) + 1
                self._pending_payload[(shard, t)] = wire

    def _flush_shard_locked(self, shard: int) -> bool:
        items = self._pending[shard]
        if not items:
            return False
        self._pending[shard] = []
        for ph, group in itertools.groupby(items, key=lambda it: it[0]):
            frags = [f for _, f in group]
            wire = self._pending_payload[(shard, ph)]
            self.execs.accumulate(shard, wire, phase=ph, fragment=frags)
            self._pending_count[(shard, ph)] -= len(frags)
            if self._pending_count[(shard, ph)] == 0:
                del self._pending_count[(shard, ph)]
                del self._pending_payload[(shard, ph)]
        return True

    def _flush_all_locked(self, write_marker: bool = True) -> None:
        """Fold every parked fragment (run/run_phase sync points).  The
        marker row makes the resume replay flush at the same point, so
        partial windows rebuild in the original fold order."""
        flushed = False
        for s in range(self.num_shards):
            flushed |= self._flush_shard_locked(s)
        if flushed and write_marker:
            self.db.write({"flushed": torch.zeros(1, dtype=torch.int32)},
                          path_id=-1, phase=max(self.clock.values()),
                          step=0, kind="flush")

    @property
    def pending_fragments(self) -> list:
        """Sorted (shard, phase, fragment) triples still in flight."""
        with self._commit_lock:
            return sorted((s, ph, f)
                          for s, items in self._pending.items()
                          for ph, f in items)

    def _complete(self, shard: int, t: int):
        """Commit a finished phase and immediately pump any shard whose
        next phase became eligible (no global barrier)."""
        with self._clock_cv:
            self.clock[shard] = max(self.clock[shard], t + 1)
            self._inflight.discard(shard)
            self._phase_done.add((shard, t))
            self._clock_cv.notify_all()
        self._pump()

    def _pump(self):
        """Enqueue every shard whose next phase is within the staleness
        window: shard s may start phase t iff t <= min(clock) +
        max_phase_lag.  With max_phase_lag=0 this is exactly the global
        barrier; with lag >= 1 fast shards run ahead of stragglers."""
        todo = []
        with self._clock_cv:
            if self._target:
                members = sorted(self.members)
                if not members:
                    return
                mn = min(self.clock[s] for s in members)
                for s in members:
                    t = self.clock[s]
                    if (t >= self._target or s in self._inflight
                            or t > mn + self.max_phase_lag):
                        continue
                    self._inflight.add(s)
                    self.max_observed_lag = max(self.max_observed_lag,
                                                t - mn)
                    todo.append((s, t))
        # every snapshot row before the first task: a pool thread that
        # picked up an earlier task could otherwise commit its rows
        # between two snapshots, and the DB's row order would depend on
        # thread timing (the run's own pump holds no lock)
        for s, t in todo:
            self._snapshot(s, t)
        for s, t in todo:
            self.queue.put(Task("train", {
                "shard_id": s, "tau": self._tau, "phase": t,
                "start_step": t * self._tau}))

    def _snapshot(self, shard: int, t: int):
        snap = self._snapshots.get(shard)
        if snap is not None and snap[0] == t:
            return     # restored from the DB (resume) or already taken
        params = self.store.assemble(int(self.worker_paths[shard]))
        self._snapshots[shard] = (t, params)
        # persisted so resume() re-runs an in-flight phase from the
        # exact theta it was issued with
        self.db.write(params, path_id=shard, phase=t, step=t * self._tau,
                      kind="snap")

    # ------------------------------------------------------------------
    def run(self, phases: int, tau: int | None = None, *,
            timeout: float | None = None) -> dict:
        """Advance every shard ``phases`` more phases, asynchronously
        pipelined.  ``run(0)`` finishes any outstanding target (after a
        resume).  Raises PhaseTimeoutError if the target is not reached."""
        if tau is not None:
            self._tau = tau
        if timeout is None:
            timeout = self.phase_timeout * max(phases, 1)
        with self._clock_cv:
            self._target += phases
            target = self._target
        self._ensure_started()
        self._pump()
        deadline = time.time() + timeout
        try:
            with self._clock_cv:
                # the wait set re-evaluates each pass: shards that
                # leave the fleet mid-wait stop being waited on
                # (leave() notifies)
                while any(self.clock[s] < target
                          for s in sorted(self.members)):
                    if time.time() >= deadline:
                        raise PhaseTimeoutError(
                            f"service did not reach phase {target}: "
                            f"clocks={self.clock} members="
                            f"{sorted(self.members)} "
                            f"queue={self.queue.stats()}")
                    self._clock_cv.wait(timeout=0.1)
        finally:
            # trace safe point: no subsystem lock held here — a timed-
            # out (about-to-be-killed) run still lands its spans
            self.tel.flush()
        # sync point: fold fragments still in flight from the last
        # phases (a marker row keeps the resume replay order-faithful);
        # losses/comm land under the commit lock, so snapshot them
        # there too — a straggler committing mid-report must not tear
        # the metrics dict we hand back
        with self._commit_lock:
            self._flush_all_locked()
            losses = dict(self.losses)
            comm = self._comm_summary()
        with self._clock_cv:
            max_lag = self.max_observed_lag
        last = target - 1
        vals = [losses[(last, s)] for s in sorted(self.members)
                if (last, s) in losses]
        mean_loss = float(np.mean(vals)) if vals and target > 0 \
            else float("nan")
        self.tel.sample_metrics("train.")
        self.tel.flush()
        return {"phases": target, "mean_loss": mean_loss,
                "outer_updates": self.execs.total_updates,
                "preemptions": self.pool.preemptions,
                "monitor_restarts": self.monitor.restarts,
                "max_observed_lag": max_lag,
                "members": sorted(self.members),
                "fleet_epoch": self.fleet.epoch,
                "comm": comm,
                "metrics": self.metrics.flat("train."),
                "transport": dict(self.transport.stats),
                "queue": self.queue.stats()}

    # ------------------------------------------------------------------
    def run_phase(self, tau: int | None = None, *,
                  sample_paths: int | None = None,
                  seed: int | None = None) -> PhaseMetrics:
        """One synchronous outer phase on the persistent pool — the
        legacy barrier API (kept bit-compatible for the equivalence
        oracle).  sample_paths: paper §2.6.2 — train only a random
        subset of paths this phase; unsampled modules keep their
        parameters.  Do not interleave with async ``run`` calls."""
        tau = tau or self.dcfg.inner_steps
        self._tau = tau
        if sample_paths is not None and sample_paths < self.num_shards:
            rng = np.random.default_rng(
                self.phase if seed is None else seed)
            active = sorted(rng.choice(self.num_shards, sample_paths,
                                       replace=False).tolist())
        else:
            active = list(range(self.num_shards))
        self.execs.set_active(active, phase=self.phase)
        for s in active:
            self._snapshots[s] = (
                self.phase,
                self.store.assemble(int(self.worker_paths[s])))
        self._ensure_started()
        self.queue.put_many([
            Task("train", {"shard_id": s, "tau": tau, "phase": self.phase,
                           "start_step": self.step})
            for s in active])
        deadline = time.time() + self.phase_timeout
        with self._clock_cv:
            while not all((s, self.phase) in self._phase_done
                          for s in active):
                if time.time() >= deadline:
                    raise PhaseTimeoutError(
                        f"phase {self.phase} did not finish: "
                        f"{self.queue.stats()}")
                self._clock_cv.wait(timeout=0.1)
        with self._commit_lock:
            self._flush_all_locked()   # barrier: no fragment in flight
            per_path = np.asarray(
                [self.losses[(self.phase, s)] for s in active])
        mean_loss = float(per_path.mean())
        self.step += tau
        self.phase += 1
        self.tel.flush()
        # comm + transport stats fold into PhaseMetrics through the
        # registry snapshot ("metrics"); "transport" stays as a
        # back-compat mirror of the transport's own dict
        return PhaseMetrics(
            mean_loss=mean_loss, final_loss=mean_loss,
            per_path_loss=per_path,
            extra={"outer_updates": self.execs.total_updates,
                   "preemptions": self.pool.preemptions,
                   "active_paths": active,
                   "comm": self._comm_summary(),
                   "metrics": self.metrics.flat("train."),
                   "transport": dict(self.transport.stats),
                   "queue": self.queue.stats()})

    # ------------------------------------------------------------------
    def path_params(self, path_id: int):
        return self.store.assemble(path_id)

    # ------------------------------------------------------------------
    def _restore_from_db(self):
        """Reconstruct service state from the checkpoint DB (§3: server
        failure recovery).  Order matters: outer state first, then
        clocks/opt/snapshots, then the order-faithful replay of train
        deltas the executors had not yet folded into an applied update."""
        rows = self.db.rows()
        # 1. outer state: module params + momentum + window phases +
        #    consumed contribution keys
        self.execs.restore_from_db(self.db)
        # 2. per-path clocks, losses, inner optimizer state, snapshots,
        #    quantizer error-feedback residuals
        latest_opt: dict = {}
        latest_snap: dict = {}
        latest_qres: dict = {}
        max_step = 0
        for r in rows:
            if r.kind == "train":
                self.clock[r.path_id] = max(self.clock[r.path_id],
                                            r.phase + 1)
                max_step = max(max_step, r.step)
                if "loss" in r.extra:
                    self.losses[(r.phase, r.path_id)] = r.extra["loss"]
                    self._phase_done.add((r.path_id, r.phase))
            elif r.kind == "opt":
                if r.phase >= latest_opt.get(r.path_id, (-1, None))[0]:
                    latest_opt[r.path_id] = (r.phase, r)
            elif r.kind == "snap":
                if r.phase >= latest_snap.get(r.path_id, (-1, None))[0]:
                    latest_snap[r.path_id] = (r.phase, r)
            elif r.kind == "qres":
                if r.phase >= latest_qres.get(r.path_id, (-1, None))[0]:
                    latest_qres[r.path_id] = (r.phase, r)
        assembled = {s: self.store.assemble(int(self.worker_paths[s]))
                     for s in range(self.num_shards)}
        for s, (_, r) in latest_opt.items():
            self.opt_states[s] = load_tree(r.file, adamw_init(assembled[s]))
        for s, (ph, r) in latest_snap.items():
            if ph == self.clock[s]:   # in-flight phase, not yet committed
                self._snapshots[s] = (ph, load_tree(r.file, assembled[s]))
        # 3. replay train deltas + flush markers in row order (== the
        #    original fold order); executors skip keys already consumed
        #    by an applied update and the ingest re-parks still-deferred
        #    fragments, so this exactly rebuilds partial windows, early
        #    buffers and the in-flight fragment set
        like32 = {s: pytree.tree_map(lambda x: x.float(), assembled[s])
                  for s in range(self.num_shards)}
        for s, (_, r) in latest_qres.items():
            # a qres row is only adopted if its phase actually
            # committed (clock has advanced past it): the residual row
            # is written just before its train row, so a kill in that
            # window leaves an *orphan* residual whose wire was never
            # folded — adopting it would double-subtract the payload
            # when the phase re-runs.  Falling back to the previous
            # committed residual reproduces exactly the state the
            # re-run's quantization originally started from.
            if r.phase >= self.clock[s]:
                prior = [q for q in rows
                         if q.kind == "qres" and q.path_id == s
                         and q.phase < self.clock[s]]
                r = prior[-1] if prior else None
            if r is not None:
                self._qresid[s] = load_tree(r.file, like32[s])
        for r in rows:
            if r.kind == "train":
                self._ingest_locked(
                    r.path_id, r.phase,
                    load_tree(r.file, like32[r.path_id]),
                    record_stats=False)
            elif r.kind == "flush":
                self._flush_all_locked(write_marker=False)
            elif r.kind == "fleet":
                # membership epochs replay at their exact point of the
                # row order: quorums shrink/grow and evicted workers
                # regain lagged-fold permission precisely where they
                # did live — resume through an epoch change stays
                # bit-exact
                self.fleet.restore_row(r)
        # 4. async bookkeeping: outstanding target covers every phase
        #    that was started (committed or in-flight)
        self._target = max(
            [self.clock[s] for s in range(self.num_shards)]
            + [ph + 1 for s, (ph, _) in latest_snap.items()
               if ph == self.clock[s]] + [0])
        self.phase = max(self.clock.values(), default=0)
        self.step = max_step
