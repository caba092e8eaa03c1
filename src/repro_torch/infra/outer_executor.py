"""Sharded outer-optimization executors (paper §3.3, Fig. 7); the port
of ``repro/infra/outer_executor.py``.

One executor per module (level, expert) plus one for the shared leaves.
Executors consume path checkpoints *online* — a delta is accumulated
into the partial sum as soon as its checkpoint appears (Online Parameter
Gradient Averaging) — and apply the Nesterov outer update once the
window's quorum of contributors has reported.  The full model therefore
never lives in one place; each executor holds only its module's
parameters and momentum (Sharded Outer Optimization Executor).

Streaming fragment-wise sync (Streaming DiLoCo): each executor
partitions its module's parameter leaves into ``fragments`` byte-
balanced fragments (core/fragments.py).  Every fragment owns an
independent accumulation window — its own partial sum, quorum
bookkeeping, *window phase counter* and Nesterov momentum slice — and
applies the moment its own quorum lands, so a module's sync is spread
across the phase instead of bursting at the boundary.  ``fragments=1``
degenerates to the classic whole-module window and is bit-identical to
the pre-fragment executor (the per-leaf operation sequence is
unchanged).

Asynchronous phase pipelining (§3, Fig. 6): contributions arrive tagged
with the reporting path's phase clock; arrivals ahead of a fragment
window are buffered until that window advances
(``TrainingService.max_phase_lag`` bounds the depth), stragglers from
an already-applied window fold into the current one
(Decoupled/Streaming-DiLoCo semantics), and each fragment applies the
moment *its* quorum lands — independently of every other fragment and
module.

With a CheckpointDB attached, each applied fragment update persists a
``kind="module"`` checkpoint.  With ``fragments=1`` that row is the
classic full-module record (params + momentum + the contribution keys
the window consumed).  With K>1 fragments each apply writes a **slice
row** carrying only its own fragment's param/momentum leaves — writing
the full module K times per phase was a K× write amplification — plus
ONE params-only **full row** (``fragment=-1``, ``extra["full"]``) per
*completed* module phase, which is what the deployment publisher cuts
manifests from.  ``restore_rows`` reassembles the slices bit-exactly:
fragments partition the leaves disjointly and a slice is written at
every apply, so overlaying each fragment's newest slice onto the
construction template reproduces the exact post-apply state.

Produces the updates of the vectorized mixing formulation
(core/diloco.py) up to the order of the f32 sums: the executors add the
contributions in commit order, the vector trainer's einsum in its own;
the quorum/lagged window matches ``core.diloco.window_outer_gradient``
and its per-fragment variant ``fragment_window_outer_gradient``.  The
windows, momenta and module rows live in f32 on the store's device.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from repro_torch.core.diloco import quorum_size
from repro_torch.core.fragments import FragmentSpec, resolve_comm_dtype
from repro_torch.core.module_store import ModuleStore
from repro_torch.core.partition import PathPartition, paths_through_module
from repro_torch.optim.nesterov import nesterov_update
from .ckpt_db import load_tree

# how many window phases back a consumed (worker, tag) key is
# remembered for dedup before being pruned; far beyond any
# max_phase_lag a service would run with
_CONSUMED_HORIZON = 64


class _FragWindow:
    """One fragment's accumulation window + outer-optimizer state."""

    __slots__ = ("fid", "indices", "phase", "updates", "mom", "acc",
                 "seen", "wsum", "early", "consumed")

    def __init__(self, fid: int, indices, mom: dict):
        self.fid = fid
        self.indices = list(indices)
        self.phase = 0               # this fragment's window phase counter
        self.updates = 0
        self.mom = mom               # {leaf_idx: fp32 momentum buffer}
        self.acc: dict = {}
        self.seen: set = set()       # (worker, tag) folded into the window
        self.wsum = 0.0
        self.early: dict = {}        # tag -> [(worker, {idx: leaf}), ...]
        self.consumed: set = set()   # keys restored from module ckpts


class _ExecutorBase:
    """Window/quorum/phase machinery shared by the per-module and the
    shared-leaves executors, one window per parameter fragment."""

    def __init__(self, member_workers, alphas, *, lr, momentum, nesterov,
                 rescale, quorum: float = 1.0, ckpt_db=None,
                 fragments: int = 1):
        self.members = set(int(w) for w in member_workers)
        self.alphas = {int(w): float(alphas[int(w)]) for w in self.members}
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov
        self.rescale = rescale
        self.quorum_frac = quorum
        self.active = set(self.members)
        self.quorum = quorum_size(quorum, len(self.active))
        # evicted workers whose in-flight stragglers may still fold as
        # lagged contributions (granted by resize_membership, revoked
        # by plain set_active path sampling)
        self._lagged_ok: set = set()
        self.db = ckpt_db
        self._lock = threading.Lock()
        self._dtype_cache: dict = {}
        params = self._params()
        self.spec = FragmentSpec(params, fragments)
        p_leaves = self.spec.flatten(params)
        # leaf shapes never change: cache them so window resets don't
        # re-flatten the module tree
        self._leaf_shapes = [tuple(x.shape) for x in p_leaves]
        self.device = p_leaves[0].device
        self.windows = [
            _FragWindow(f, self.spec.indices[f],
                        {i: self._zeros(i) for i in self.spec.indices[f]})
            for f in range(self.spec.num_fragments)]
        # newest completed module phase a full (fragment=-1) row was
        # written for; K=1 modules never write separate full rows
        self._full_written = -1
        self._reset()

    # -- legacy single-window accessors (valid views for fragments=1,
    # -- which every pre-streaming caller and test uses) ----------------
    @property
    def phase(self) -> int:
        return min(w.phase for w in self.windows)

    @property
    def updates(self) -> int:
        return sum(w.updates for w in self.windows)

    @property
    def seen(self) -> set:
        return self.windows[0].seen

    @property
    def wsum(self) -> float:
        return self.windows[0].wsum

    @property
    def _early(self) -> dict:
        return self.windows[0].early

    @property
    def mom_state(self) -> dict:
        return {"momentum": self._momentum_tree()}

    def _momentum_tree(self):
        leaves = [None] * self.spec.num_leaves
        for w in self.windows:
            for i in w.indices:
                leaves[i] = w.mom[i]
        return self.spec.unflatten(leaves)

    # -- subclass surface ----------------------------------------------
    def _params(self):
        raise NotImplementedError

    def _slice(self, delta_tree):
        raise NotImplementedError

    def _write(self, cast):
        raise NotImplementedError

    def _ckpt_id(self) -> tuple:
        raise NotImplementedError    # (level, expert); (-1, -1) = shared

    # ------------------------------------------------------------------
    def set_active(self, active_workers, phase: int | None = None) -> None:
        """Path sampling (paper §2.6.2): only a subset of paths trains
        this phase; the module updates from whichever of its
        contributors are active (none active -> module untouched).
        ``phase`` aligns every fragment's window counter in barrier
        mode, where an executor may sit out whole phases — there the
        windows are reset for the fresh phase.  Without ``phase``
        (mid-run resizing) accumulating windows are *preserved* and
        re-checked against the recomputed quorum: shrinking the fleet
        must never strand a window that already meets the new bar."""
        with self._lock:
            self.active = self.members & set(int(w) for w in active_workers)
            self._lagged_ok = set()
            self.quorum = quorum_size(self.quorum_frac, len(self.active))
            if phase is not None:
                for w in self.windows:
                    w.phase = int(phase)
                    w.early.clear()
                self._reset()
            else:
                for w in self.windows:
                    self._check_quorum_locked(w)

    def resize_membership(self, active_workers) -> None:
        """Elastic fleet join/leave: like :meth:`set_active` mid-run,
        but workers evicted by this change keep permission to fold
        their in-flight stragglers as lagged contributions (they never
        double-count — the ``(worker, tag)`` dedup holds across the
        membership change)."""
        with self._lock:
            new_active = self.members & set(
                int(w) for w in active_workers)
            evicted = self.active - new_active
            self._lagged_ok = (self._lagged_ok | evicted) - new_active
            self.active = new_active
            self.quorum = quorum_size(self.quorum_frac, len(new_active))
            for w in self.windows:
                self._check_quorum_locked(w)

    def _check_quorum_locked(self, win: _FragWindow) -> None:
        """Satellite fix: a membership change recomputes the quorum —
        apply any window the (possibly lower) bar is already met by,
        then drain early arrivals the advance unlocked."""
        if win.seen and len({w for w, _ in win.seen}) >= self.quorum:
            self._apply_locked(win)
        self._drain_locked(win)

    def _reset(self):
        for w in self.windows:
            self._reset_window(w)

    def _zeros(self, i: int) -> torch.Tensor:
        return torch.zeros(self._leaf_shapes[i], dtype=torch.float32,
                           device=self.device)

    def _reset_window(self, win: _FragWindow):
        win.acc = {i: self._zeros(i) for i in win.indices}
        win.seen = set()
        win.wsum = 0.0

    def accumulate(self, worker_id: int, delta_tree,
                   phase: int | None = None,
                   fragment=None) -> bool:
        """Online accumulation; returns True if any fragment window
        reached quorum and applied its outer update.  quorum < 1.0 =
        async outer updates: stragglers fold into the next accumulation
        window.  ``fragment`` restricts the fold to one fragment id or
        a sequence of ids (one send-slot of the staggered schedule,
        folded with a single delta slice); None folds every fragment
        of the contribution."""
        with self._lock:
            # membership must be decided under the lock: a concurrent
            # set_active could otherwise drop or double-count this
            # contribution mid-accumulation; workers evicted by an
            # elastic resize keep folding their stragglers as lagged
            if (worker_id not in self.active
                    and worker_id not in self._lagged_ok):
                return False
            if fragment is None:
                windows = self.windows
            else:
                fids = ([fragment] if isinstance(fragment, int)
                        else list(fragment))
                # spec may clamp K below the requested fragment count:
                # this module's leaves are fully covered by lower ids
                windows = [self.windows[f] for f in fids
                           if f < self.spec.num_fragments]
                if not windows:
                    return False
            leaves = None      # sliced lazily: duplicates (resume
            applied = False    # replay, retried tasks) stay O(1)
            for win in windows:
                tag = win.phase if phase is None else int(phase)
                key = (worker_id, tag)
                if (key in win.seen or key in win.consumed
                        or any(w == worker_id
                               for w, _ in win.early.get(tag, ()))):
                    continue   # duplicate (retried task / replay)
                if leaves is None:
                    leaves = self.spec.flatten(self._slice(delta_tree))
                part = {i: leaves[i] for i in win.indices}
                if tag > win.phase:
                    # the path raced ahead of this fragment's window:
                    # buffer until the window advances
                    win.early.setdefault(tag, []).append((worker_id, part))
                    continue
                applied |= self._fold_locked(win, worker_id, tag, part)
                self._drain_locked(win)
            return applied

    def _fold_locked(self, win, worker_id, tag, part) -> bool:
        a = self.alphas[worker_id]
        for i, leaf in part.items():
            win.acc[i] = win.acc[i] + a * leaf.float()
        win.wsum += a
        win.seen.add((worker_id, tag))
        if len({w for w, _ in win.seen}) < self.quorum:
            return False
        self._apply_locked(win)
        return True

    def _drain_locked(self, win):
        """Fold buffered early arrivals that the advancing window has
        caught up with (each fold may itself fire an apply)."""
        while True:
            tags = sorted(t for t in win.early if t <= win.phase)
            if not tags:
                return
            bucket = win.early[tags[0]]
            worker_id, part = bucket.pop(0)
            if not bucket:
                del win.early[tags[0]]
            self._fold_locked(win, worker_id, tags[0], part)

    def _apply_locked(self, win):
        # rescale by the number of *contributions* (== distinct workers
        # in the synchronous case) — keeps the update equal to
        # core.diloco.window_outer_gradient when a straggler worker
        # lands two phases in one window
        scale = (math.sqrt(len(win.seen)) if self.rescale else 1.0) \
            / max(win.wsum, 1e-12)
        params = self._params()
        p_leaves = self.spec.flatten(params)
        new_leaves = list(p_leaves)
        for i in win.indices:
            upd, st = nesterov_update(
                {"x": win.acc[i] * scale},
                {"momentum": {"x": win.mom[i]}},
                {"x": p_leaves[i].float()},
                lr=self.lr, momentum=self.momentum,
                nesterov=self.nesterov)
            new_leaves[i] = upd["x"].to(p_leaves[i].dtype)
            win.mom[i] = st["momentum"]["x"]
        cast = self.spec.unflatten(new_leaves)
        self._write(cast)
        win.updates += 1
        applied_phase = win.phase
        consumed = sorted(win.seen)
        # a replayed send (task re-leased after lease expiry, transport
        # duplicate) arriving after this apply must be a no-op in the
        # next window, not a second fold inflating wsum: remember what
        # this window consumed, pruned to a phase horizon
        win.consumed.update(win.seen)
        if len(win.consumed) > 4 * _CONSUMED_HORIZON:
            floor = win.phase - _CONSUMED_HORIZON
            win.consumed = {k for k in win.consumed if k[1] >= floor}
        win.phase = applied_phase + 1
        self._reset_window(win)
        if self.db is not None:
            self._persist_locked(win, cast, applied_phase, consumed)

    def _slice_like(self, win) -> dict:
        """Template for one fragment's slice row: its param leaves (at
        store dtype, int8/int4 included) + fp32 momentum leaves."""
        p_leaves = self.spec.flatten(self._params())
        return {"params": {i: p_leaves[i] for i in win.indices},
                "momentum": {i: self._zeros(i) for i in win.indices}}

    def _persist_locked(self, win, cast, applied_phase, consumed):
        """Checkpoint one fragment apply.

        K=1: the classic full row (params + momentum), unchanged.  K>1:
        a params-only full row first when this apply *completes* a
        module phase (ordering matters — if the full row were written
        after the slice and the process died between them, resume would
        mark the phase complete without a publishable payload), then
        the fragment's slice row.  Per module phase that is
        K·(P+M)/K + P ≈ P+M+P bytes instead of K·(P+M) — the Θ(K)
        write amplification the ROADMAP called out.
        """
        level, expert = self._ckpt_id()
        extra = {"consumed": [[int(w), int(t)] for w, t in consumed],
                 "updates": int(win.updates),
                 "frag_phase": int(applied_phase),
                 "num_fragments": int(self.spec.num_fragments)}
        if self.spec.num_fragments == 1:
            self.db.write(
                {"params": cast, "momentum": self.mom_state},
                path_id=-1, phase=applied_phase, step=self.updates,
                kind="module", level=level, expert=expert,
                fragment=win.fid, extra=extra)
            return
        done = min(w.phase for w in self.windows) - 1
        if done > self._full_written:
            self.db.write(
                {"params": cast},
                path_id=-1, phase=done, step=self.updates,
                kind="module", level=level, expert=expert,
                fragment=-1,
                extra={"full": True, "updates": int(self.updates),
                       "frag_phase": int(done),
                       "num_fragments": int(self.spec.num_fragments)})
            self._full_written = done
        c_leaves = self.spec.flatten(cast)
        self.db.write(
            {"params": {i: c_leaves[i] for i in win.indices},
             "momentum": {i: win.mom[i] for i in win.indices}},
            path_id=-1, phase=applied_phase, step=self.updates,
            kind="module", level=level, expert=expert,
            fragment=win.fid, extra=extra)

    def resolve_dtypes(self, policy: str, comm_dtype: str):
        """Per-leaf wire dtypes of this executor's module under a comm
        policy, cached (pure function of the module template)."""
        key = (policy, comm_dtype)
        if key not in self._dtype_cache:
            self._dtype_cache[key] = resolve_comm_dtype(
                policy, comm_dtype, self._params())
        return self._dtype_cache[key]

    # -- recovery (TrainingService.resume) -----------------------------
    def ckpt_like(self):
        return {"params": self._params(), "momentum": self.mom_state}

    def restore_rows(self, rows) -> None:
        """Reset to the state right after the last apply each fragment
        recorded.  ``rows`` are this executor's ``kind="module"`` rows
        in commit order, and every row's contribution keys are marked
        consumed so the train-delta replay stays order-faithful.

        K=1 rows are full (params + momentum): module params come from
        the newest row, each fragment's momentum/phase from its own
        newest row.  K>1 rows are per-fragment slices: each fragment's
        newest slice is overlaid onto the construction template —
        fragments partition the leaves disjointly and a slice is
        written at *every* apply, so the overlay is bit-exactly the
        newest state of every leaf (full rows are publisher payloads
        and are skipped here)."""
        if not rows:
            return
        with self._lock:
            if self.spec.num_fragments > 1:
                self._restore_sliced_locked(rows)
                return
            rows = [r for r in rows if not r.extra.get("full")]
            if not rows:
                return
            ks = {int(r.extra.get("num_fragments", 1)) for r in rows}
            if ks - {1}:
                raise ValueError(
                    f"module {self._ckpt_id()}: rows were written with "
                    f"{sorted(ks)} fragments but this executor runs "
                    f"with 1 — resume across a fragment-count change "
                    f"is not supported")
            like = self.ckpt_like()
            cache: dict = {}

            def tree_of(row):
                if row.file not in cache:
                    cache[row.file] = load_tree(row.file, like)
                return cache[row.file]

            cast = tree_of(rows[-1])["params"]
            self._write(cast)
            latest: dict = {}
            for r in rows:
                fid = r.fragment if r.fragment >= 0 else 0
                if fid >= self.spec.num_fragments:
                    continue
                latest[fid] = r
                self.windows[fid].consumed.update(
                    (int(w), int(t)) for w, t in
                    r.extra.get("consumed", []))
            for fid, r in latest.items():
                win = self.windows[fid]
                mom = self.spec.flatten(
                    tree_of(r)["momentum"]["momentum"])
                win.mom = {i: mom[i] for i in win.indices}
                win.phase = int(r.extra.get("frag_phase", r.phase)) + 1
                win.updates = int(r.extra.get("updates", r.step))
                win.early.clear()
                self._reset_window(win)

    def _restore_sliced_locked(self, rows) -> None:
        """K>1 resume: overlay each fragment's newest slice row."""
        ks = {int(r.extra.get("num_fragments", 1)) for r in rows}
        if ks - {self.spec.num_fragments}:
            raise ValueError(
                f"module {self._ckpt_id()}: rows were written with "
                f"{sorted(ks)} fragments but this executor runs with "
                f"{self.spec.num_fragments} — resume across a "
                f"fragment-count change is not supported")
        latest: dict = {}
        for r in rows:
            if r.extra.get("full") or r.fragment < 0:
                continue   # publisher payload, not resume state
            if r.fragment >= self.spec.num_fragments:
                continue
            latest[r.fragment] = r
            self.windows[r.fragment].consumed.update(
                (int(w), int(t)) for w, t in
                r.extra.get("consumed", []))
        if not latest:
            return
        p_leaves = self.spec.flatten(self._params())
        new_leaves = list(p_leaves)
        for fid, r in latest.items():
            win = self.windows[fid]
            tree = load_tree(r.file, self._slice_like(win))
            for i in win.indices:
                new_leaves[i] = tree["params"][i]
                win.mom[i] = tree["momentum"][i]
            win.phase = int(r.extra.get("frag_phase", r.phase)) + 1
            win.updates = int(r.extra.get("updates", r.step))
            win.early.clear()
            self._reset_window(win)
        self._write(self.spec.unflatten(new_leaves))
        # a completed phase restored from slices already has its full
        # row on disk (written before the completing slice): don't
        # re-write it on the next apply
        self._full_written = min(w.phase for w in self.windows) - 1


class _ModuleExecutor(_ExecutorBase):
    def __init__(self, store: ModuleStore, level: int, expert: int,
                 member_workers, alphas, *, lr, momentum, nesterov,
                 rescale, quorum: float = 1.0, ckpt_db=None,
                 fragments: int = 1):
        self.store = store
        self.level, self.expert = level, expert
        super().__init__(member_workers, alphas, lr=lr, momentum=momentum,
                         nesterov=nesterov, rescale=rescale, quorum=quorum,
                         ckpt_db=ckpt_db, fragments=fragments)

    def _params(self):
        return self.store.module_params(self.level, self.expert)

    def _slice(self, delta_tree):
        return self.store.slice_for_level(delta_tree, self.level)

    def _write(self, cast):
        self.store.set_module(self.level, self.expert, cast)

    def _ckpt_id(self):
        return (self.level, self.expert)


class _SharedExecutor(_ExecutorBase):
    """Embeddings / final norm — shared by all paths (or untouched when
    unshared; then each path's copy is updated independently)."""

    def __init__(self, store: ModuleStore, num_workers: int, alphas, *,
                 lr, momentum, nesterov, rescale, quorum: float = 1.0,
                 ckpt_db=None, fragments: int = 1):
        self.store = store
        super().__init__(range(num_workers), alphas, lr=lr,
                         momentum=momentum, nesterov=nesterov,
                         rescale=rescale, quorum=quorum, ckpt_db=ckpt_db,
                         fragments=fragments)

    def _params(self):
        return self.store.shared

    def _slice(self, delta_tree):
        return self.store.shared_of(delta_tree)

    def _write(self, cast):
        self.store.set_shared(cast)

    def _ckpt_id(self):
        return (-1, -1)


class ShardedOuterExecutors:
    def __init__(self, store: ModuleStore, partition: PathPartition,
                 worker_paths, alphas=None, *, lr=0.7, momentum=0.9,
                 nesterov=True, rescale=True, quorum: float = 1.0,
                 ckpt_db=None, fragments: int = 1):
        worker_paths = np.asarray(worker_paths)
        W = len(worker_paths)
        if alphas is None:
            alphas = np.ones(W) / W
        self.fragments = max(1, int(fragments))
        self.execs = {}
        for l in range(partition.num_levels):
            n_experts = int(partition.paths[:, l].max()) + 1
            for e in range(n_experts):
                paths = paths_through_module(partition, l, e)
                members = [w for w in range(W)
                           if worker_paths[w] in paths]
                if not members:
                    continue
                self.execs[(l, e)] = _ModuleExecutor(
                    store, l, e, members, alphas, lr=lr, momentum=momentum,
                    nesterov=nesterov, rescale=rescale, quorum=quorum,
                    ckpt_db=ckpt_db, fragments=fragments)
        self.shared_exec = None
        if partition.shared_embeddings:
            self.shared_exec = _SharedExecutor(
                store, W, alphas, lr=lr, momentum=momentum,
                nesterov=nesterov, rescale=rescale, quorum=quorum,
                ckpt_db=ckpt_db, fragments=fragments)

    def _all(self) -> dict:
        out = dict(self.execs)
        if self.shared_exec is not None:
            out[(-1, -1)] = self.shared_exec
        return out

    def set_active(self, active_workers, phase: int | None = None) -> None:
        """Path sampling (§2.6.2): restrict this phase's contributors."""
        for ex in self._all().values():
            ex.set_active(active_workers, phase=phase)

    def resize_membership(self, active_workers) -> None:
        """Elastic fleet join/leave across every executor: quorums
        recompute, filled windows drain, evicted workers keep lagged-
        fold permission for their in-flight stragglers."""
        for ex in self._all().values():
            ex.resize_membership(active_workers)

    def accumulate(self, worker_id: int, delta_tree,
                   phase: int | None = None, fragment=None) -> list:
        """Feed one path checkpoint (or one fragment / one send-slot's
        worth of fragments of it); returns the modules with at least
        one fragment window completed by it."""
        completed = []
        for key, ex in self.execs.items():
            if ex.accumulate(worker_id, delta_tree, phase=phase,
                             fragment=fragment):
                completed.append(key)
        if self.shared_exec is not None:
            if self.shared_exec.accumulate(worker_id, delta_tree,
                                           phase=phase,
                                           fragment=fragment):
                completed.append("shared")
        return completed

    def frag_bytes(self, worker_id: int, fragment: int,
                   comm_dtype: str = "fp32", *,
                   policy: str = "uniform") -> int:
        """Simulated wire bytes worker ``worker_id`` ships for fragment
        ``fragment`` of one report (sum over the modules it feeds).
        ``policy="leafwise"`` prices each module with its per-leaf
        dtype mix (int4 matmuls / fp32 norms)."""
        total = 0
        for ex in self._all().values():
            if (worker_id in ex.members
                    and fragment < ex.spec.num_fragments):
                total += ex.spec.wire_bytes(
                    fragment, ex.resolve_dtypes(policy, comm_dtype))
        return total

    def restore_from_db(self, db) -> None:
        """Rebuild every executor's params, per-fragment momentum and
        window phases from its ``kind="module"`` rows, and mark the
        contribution keys recorded by *all* rows as consumed so a
        subsequent train-delta replay is exactly order-faithful."""
        by_mid: dict = {}
        for row in db.rows(kind="module"):
            by_mid.setdefault((row.level, row.expert), []).append(row)
        for k, rows in by_mid.items():
            ex = self._all().get(k)
            if ex is not None:
                ex.restore_rows(rows)

    @property
    def total_updates(self) -> int:
        return sum(ex.updates for ex in self._all().values())
