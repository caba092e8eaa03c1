"""Publisher: the control loop that turns training-plane checkpoint
rows into promoted serving versions; the port of
``repro/deploy/publisher.py``.

Subscribes to the checkpoint DB's listener API (no polling of
``wait_for``): every ``kind="module"`` row — one per applied outer
update, written by the sharded executors — wakes the publisher.  When
every module of the partition has applied outer phase ``t`` (the phase
is *complete*), the publisher cuts a candidate manifest from the latest
row per module, canary-gates it against the serving version on the
shadow trace, and promotes it on pass.  An optional bake gate re-scores
the freshly promoted version on a second, disjoint shadow trace and
rolls back automatically on regression; rejected or rolled-back
compositions are quarantined so a bad version is never re-promoted.

The cycle itself is synchronous and cheap when there is nothing to do
(``publish_cycle``), which keeps tests deterministic; ``start()`` wraps
it in a daemon thread driven by the DB listener for live deployments.
"""
from __future__ import annotations

import json
import os
import threading

from repro_torch.obs import as_telemetry

from .manifest import Manifest


class Publisher:
    def __init__(self, db, registry, *, gate=None, bake_gate=None,
                 auto_rollback: bool = True, telemetry=None):
        self.db = db
        self.registry = registry
        self.gate = gate
        self.bake_gate = bake_gate
        self.auto_rollback = auto_rollback
        self.tel = as_telemetry(telemetry)
        self.published = 0
        self.rejected = 0
        self.rollbacks = 0
        self.cycle_errors = 0
        self.last_error: Exception | None = None
        # signatures never to re-promote — persisted in the registry
        # root so a restarted publisher does not re-promote a version a
        # previous process rejected or auto-rolled-back
        self._quarantine_file = os.path.join(registry.root,
                                             "QUARANTINE.json")
        self._quarantined: set = self._load_quarantine()
        self._event = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        self._cycle_lock = threading.Lock()
        # resume: don't re-cut a phase an earlier process already
        # published.  Manifests record the completed phase they were
        # cut at (cut_phase); with staggered fragments the ref row
        # phases can run *ahead* of it (the newest row per module is
        # whichever fragment applied last), so min-over-refs — the
        # pre-fragment fallback — would overshoot and skip the next
        # completed phase after a restart.
        latest = registry.latest_manifest()
        if latest is None:
            self._last_cut_phase = -1
        else:
            cut = (latest.cut_phase if latest.cut_phase >= 0 else
                   min((r.phase for r in latest.refs), default=-1))
            # a cut that was never promoted (the process died between
            # register and promote — the chaos window) must not be
            # treated as published: back off one phase so the first
            # cycle re-cuts it (register() dedupes to the same
            # version) and the retry promotes instead of stranding
            # the candidate forever.  Quarantined cuts (rejected or
            # auto-rolled-back by a previous process; the quarantine
            # is persisted) are handled, not stranded — no backoff.
            handled = (latest.version == registry.serving_version
                       or latest.version in registry.promotion_history
                       or latest.signature in self._quarantined)
            self._last_cut_phase = cut if handled else cut - 1
        db.add_listener(self._on_row)

    # -- quarantine persistence ----------------------------------------
    def _load_quarantine(self) -> set:
        try:
            with open(self._quarantine_file) as f:
                return {tuple(sig) for sig in json.load(f)}
        except (OSError, ValueError):
            return set()

    def _quarantine(self, signature) -> None:
        self._quarantined.add(signature)
        tmp = self._quarantine_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump([list(s) for s in sorted(self._quarantined)], f)
        os.replace(tmp, self._quarantine_file)

    # -- event plumbing ------------------------------------------------
    def _on_row(self, row) -> None:
        if row.kind == "module":
            self._event.set()

    def close(self) -> None:
        self._stop.set()
        self._event.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.db.remove_listener(self._on_row)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- bootstrap -----------------------------------------------------
    def bootstrap(self) -> Manifest:
        """Ensure a serving version exists before any outer update has
        landed: register (and promote) the base-template composition."""
        m = self.registry.register(note="bootstrap: base initialization")
        if self.registry.serving_version is None:
            self.registry.promote(m.version)
        return m

    # -- candidate detection -------------------------------------------
    def _scan(self):
        """(completed phase, latest module row per id).  Rows are in
        commit order, so the last row per module is its newest.

        With streaming fragment-wise sync a module's update for phase t
        lands as one *slice* row per fragment window plus one
        params-only full row (``extra["full"]``) when the phase
        completes; a candidate is cut only at *fragment-complete*
        versions — a module counts phase t done once every one of its
        fragments (``num_fragments`` rides on each row) has applied
        phase >= t, so a half-synced module can never leak into a
        serving manifest.  Only full rows become manifest payloads:
        slice rows carry a single fragment's leaves and cannot
        materialize a module (K=1 rows are full by construction)."""
        latest: dict = {}
        frag_phase: dict = {}
        frag_expect: dict = {}
        for r in self.db.rows(kind="module"):
            mid = (r.level, r.expert)
            if r.extra.get("full"):
                latest[mid] = r     # completeness tracked via slices
                continue
            fid = r.fragment if r.fragment >= 0 else 0
            ph = int(r.extra.get("frag_phase", r.phase))
            cur = frag_phase.setdefault(mid, {})
            cur[fid] = max(cur.get(fid, -1), ph)
            frag_expect[mid] = int(r.extra.get("num_fragments", 1))
            if frag_expect[mid] == 1:
                latest[mid] = r
        completed = -1
        for mid in self.registry.module_ids:
            frags = frag_phase.get(mid)
            if frags is None or len(frags) < frag_expect.get(mid, 1):
                return -1, latest          # a fragment never applied
            mod_done = min(frags.values())
            completed = mod_done if completed < 0 else min(completed,
                                                           mod_done)
        return completed, latest

    def completed_phase(self) -> int:
        """Highest outer phase applied by every fragment of *every*
        module (-1 if any fragment has no applied update yet)."""
        return self._scan()[0]

    def poll(self) -> Manifest | None:
        """Cut a candidate manifest if a new outer phase completed."""
        completed, latest = self._scan()
        if completed <= self._last_cut_phase:
            return None
        m = self.registry.register(latest,
                                   note=f"outer phase {completed} complete",
                                   cut_phase=completed)
        self._last_cut_phase = completed
        return m

    # -- the deployment cycle ------------------------------------------
    def publish_cycle(self) -> dict:
        """One full cycle: detect -> cut -> canary -> promote (or
        reject) -> bake -> rollback on regression."""
        try:
            with self._cycle_lock:
                out = {"cut": None, "promoted": None, "rejected": None,
                       "rolled_back": None, "report": None}
                prev_cut = self._last_cut_phase
                m = self.poll()
                if m is None:
                    return out
                try:
                    with self.tel.span("deploy.cycle",
                                       version=m.version) as sp:
                        out = self._cycle_body(out, m)
                        sp.set(promoted=out["promoted"],
                               rejected=out["rejected"],
                               rolled_back=out["rolled_back"])
                    return out
                except BaseException:
                    # crashed mid-cycle (gate error, promote died
                    # before the pointer replace): rewind the cut
                    # bookkeeping so the next cycle re-cuts this phase
                    # — register() dedupes to the same version, so the
                    # retry promotes instead of losing the candidate
                    # until the next phase completes
                    self._last_cut_phase = prev_cut
                    raise
        finally:
            # trace safe point: outside _cycle_lock (the flush does IO)
            self.tel.flush()

    def _cycle_body(self, out: dict, m: Manifest) -> dict:
        out["cut"] = m.version
        if m.signature in self._quarantined:
            out["rejected"] = m.version
            self.rejected += 1
            return out
        prev = self.registry.serving_version
        if prev is not None and prev == m.version:
            return out
        if self.gate is not None and prev is not None:
            with self.tel.span("deploy.canary", version=m.version,
                               stage="canary") as sp:
                report = self.gate.evaluate(
                    self.registry.materialize(m.version),
                    self.registry.serving_paths())
                sp.set(passed=bool(report.passed))
            out["report"] = report
            if not report.passed:
                self._quarantine(m.signature)
                self.rejected += 1
                out["rejected"] = m.version
                self.tel.instant("deploy.reject", version=m.version)
                return out
        self.registry.promote(m.version)
        self.published += 1
        out["promoted"] = m.version
        self.tel.instant("deploy.promote", version=m.version)
        if self.bake_gate is not None and prev is not None:
            with self.tel.span("deploy.canary", version=m.version,
                               stage="bake") as sp:
                bake = self.bake_gate.evaluate(
                    self.registry.serving_paths(),
                    self.registry.materialize(prev))
                sp.set(passed=bool(bake.passed))
            out["report"] = bake
            if not bake.passed and self.auto_rollback:
                self._quarantine(m.signature)
                self.registry.rollback()
                self.rollbacks += 1
                out["rolled_back"] = m.version
                out["promoted"] = None
                self.tel.instant("deploy.rollback", version=m.version)
        return out

    # -- background mode -----------------------------------------------
    def start(self, period: float = 0.5) -> "Publisher":
        """Run publish cycles on a daemon thread, woken by module-row
        writes (and at least every ``period`` seconds as a fallback)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self._event.wait(timeout=period)
                self._event.clear()
                if self._stop.is_set():
                    return
                try:
                    self.publish_cycle()
                except Exception as e:  # noqa: BLE001
                    # an always-on publisher must survive transient
                    # failures (disk full, a row GC'd mid-cut, gate
                    # scoring errors): a dead daemon would leave
                    # engines silently serving stale weights forever
                    self.cycle_errors += 1
                    self.last_error = e

        self._thread = threading.Thread(target=loop, name="publisher",
                                        daemon=True)
        self._thread.start()
        return self
