"""Deployment registry: versioned, content-addressed module storage with
an atomically tagged "serving" version; the port of
``repro/deploy/registry.py``.

The registry is the boundary between the training plane (which emits
per-module checkpoint rows, infra/ckpt_db.py) and the serving plane
(engines that need full path parameter trees).  It owns three things:

 * a **content-addressed store** (``root/modules/<digest>.npz``): every
   module payload referenced by any manifest is copied in exactly once,
   keyed by its content hash — shared modules are stored and loaded
   once no matter how many paths or versions reference them, and a
   rolled-back version re-materializes from the same immutable bytes
   (checkpoint-DB garbage collection cannot invalidate a manifest);
 * **manifests** (``root/manifests/v<N>.json``): immutable version
   descriptions (deploy/manifest.py);
 * the **serving pointer** (``root/SERVING``): the tagged serving
   version plus its promotion history, rewritten via ``os.replace`` so
   promote/rollback are atomic both for in-process readers (lock) and
   for other processes watching the file.

The layout, the manifests' JSON, the digests and the row files are the
reference's, so either package opens a registry the other wrote.

``materialize`` composes path trees the same way the training-side
``ModuleStore`` does — module payloads are loaded once into a digest
cache and every path that routes through a module reuses that one copy;
assembled path lists are memoized by manifest signature, which is what
makes rollback bit-exact: re-promoting a previous version returns the
very tensors the engines served before.  Paths materialize on the
registry's ``device``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import torch

from repro_torch.core import pytree
from repro_torch.core.module_store import ModuleStore
from repro_torch.core.partition import make_partition
from repro_torch.device import resolve_device
from repro_torch.infra.ckpt_db import load_tree
from repro_torch.models import api
from repro_torch.models.params import param_axes

from .manifest import SHARED_ID, Manifest, ModuleRef, file_digest, \
    tree_digest


def _momentum_like(tree):
    """The outer optimizer's state template of a module tree (the
    reference's ``nesterov_init`` of its f32 copy; ``None`` nodes
    kept)."""
    return {"momentum": pytree.tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), tree)}


class DeploymentRegistry:
    """Versioned module registry + serving pointer for one deployment.

    Construct with the same ``cfg``/``dcfg``/base initialization as the
    training service that produces the checkpoint rows — the base
    template is both the assembly skeleton (treedefs, shapes, dtypes)
    and the payload for modules that have not received an outer update
    yet (``base_params``, else ``init_model(cfg, seed=seed)``).  A fresh
    process pointed at the same ``root`` reconstructs the full version
    history (manifests + serving pointer are on disk).
    """

    def __init__(self, cfg, dcfg, root: str, *, seed: int = 0,
                 base_params=None, max_cached_versions: int = 3,
                 device="cuda"):
        self.cfg, self.dcfg = cfg, dcfg
        self.root = root
        self.device = resolve_device(device)
        self.partition = make_partition(dcfg, cfg.pattern_repeats)
        self.num_paths = self.partition.num_paths
        os.makedirs(os.path.join(root, "modules"), exist_ok=True)
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)
        if base_params is None:
            base_params = api.init_model(cfg, seed=seed, device=self.device)
        else:
            base_params = pytree.tree_map(lambda x: x.to(self.device),
                                          base_params)
        self._store = ModuleStore(base_params, param_axes(cfg),
                                  self.partition)
        # base payloads (and their digests) for modules with no rows yet
        self.module_ids = []
        self._base: dict = {}
        for level in range(self.partition.num_levels):
            n_experts = int(self.partition.paths[:, level].max()) + 1
            for expert in range(n_experts):
                self.module_ids.append((level, expert))
                self._base[(level, expert)] = \
                    self._store.module_params(level, expert)
        if self.partition.shared_embeddings:
            self.module_ids.append(SHARED_ID)
            self._base[SHARED_ID] = self._store.shared
        self._base_digest = {mid: tree_digest(t)
                             for mid, t in self._base.items()}
        self._lock = threading.RLock()
        self._manifests: dict = {}
        self._by_signature: dict = {}        # signature -> version
        self._serving: int | None = None
        self._history: list = []
        self._ptr_stat = None
        self._payload_cache: dict = {}       # digest -> module tree
        self._assembled: dict = {}           # signature -> [path params]
        self.max_cached_versions = max_cached_versions
        # chaos/fault-injection hook (tests): called with a named point
        # ("promote:pre_pointer", "pointer:pre_replace",
        # "rollback:pre_pointer"); raising simulates a crash there.
        self.fault_injector = None
        self._load_state()

    def _fault(self, point: str) -> None:
        if self.fault_injector is not None:
            self.fault_injector(point)

    # -- persistence ---------------------------------------------------
    def _manifest_path(self, version: int) -> str:
        return os.path.join(self.root, "manifests", f"v{version:05d}.json")

    def _ptr_path(self) -> str:
        return os.path.join(self.root, "SERVING")

    def _scan_manifests_locked(self) -> None:
        mdir = os.path.join(self.root, "manifests")
        for name in sorted(os.listdir(mdir)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(mdir, name)) as f:
                m = Manifest.from_json(f.read())
            if m.version not in self._manifests:
                self._manifests[m.version] = m
                self._by_signature.setdefault(m.signature, m.version)

    def _load_state(self) -> None:
        self._scan_manifests_locked()
        self._refresh_locked(force=True)

    def _refresh_locked(self, force: bool = False) -> None:
        """Pick up promotes/rollbacks made by *other processes*: the
        SERVING pointer is rewritten atomically, so readers re-stat it
        and reload on change (plus any manifests minted since).  Engines
        read ``serving_version`` every tick — a stat is cheap enough."""
        ptr = self._ptr_path()
        try:
            st = os.stat(ptr)
        except FileNotFoundError:
            return
        key = (st.st_ino, st.st_mtime_ns, st.st_size)
        if not force and key == self._ptr_stat:
            return
        with open(ptr) as f:
            d = json.load(f)
        self._ptr_stat = key
        known = set(self._manifests)
        wanted = set(d.get("history", [])) | \
            ({d["serving"]} if d["serving"] is not None else set())
        if wanted - known:
            self._scan_manifests_locked()
        self._serving = d["serving"]
        self._history = list(d.get("history", []))

    def _write_pointer_locked(self) -> None:
        ptr = self._ptr_path()
        tmp = ptr + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"serving": self._serving,
                       "history": self._history}, f)
        self._fault("pointer:pre_replace")   # crash window: tmp written
        os.replace(tmp, ptr)     # atomic: readers see old or new, never mixed
        st = os.stat(ptr)
        self._ptr_stat = (st.st_ino, st.st_mtime_ns, st.st_size)

    # -- registration --------------------------------------------------
    def register(self, rows: dict | None = None, *,
                 note: str = "", cut_phase: int = -1) -> Manifest:
        """Cut a manifest from checkpoint rows (``module-id -> CkptRow``).

        Module ids without a row keep their base-template payload.  Row
        files are copied into the content-addressed store, so the
        manifest stays valid after the checkpoint DB garbage-collects
        the originals.  Registering a composition that any known
        manifest already pins returns that manifest instead of minting
        a version (a resumed deployment re-cutting a published phase
        gets the original back).
        """
        rows = rows or {}
        unknown = set(rows) - set(self.module_ids)
        if unknown:
            raise ValueError(f"rows for unknown module ids {sorted(unknown)};"
                             f" registry knows {self.module_ids}")
        refs = []
        for mid in self.module_ids:
            row = rows.get(mid)
            if row is None:
                refs.append(ModuleRef(level=mid[0], expert=mid[1],
                                      digest=self._base_digest[mid]))
                continue
            digest = file_digest(row.file)
            cas = os.path.join(self.root, "modules", f"{digest}.npz")
            if not os.path.exists(cas):
                # a temporary file per writer: two registrations of the
                # same digest write identical bytes, and either replace
                # may land last
                fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cas),
                                           suffix=".tmp")
                os.close(fd)
                shutil.copyfile(row.file, tmp)
                os.replace(tmp, cas)
            refs.append(ModuleRef(
                level=mid[0], expert=mid[1], digest=digest, file=cas,
                phase=row.phase,
                step=int(row.extra.get("updates", row.step))))
        with self._lock:
            latest = self.latest_manifest()
            m = Manifest(version=(latest.version + 1 if latest else 1),
                         refs=tuple(refs),
                         parent=self._serving if self._serving else -1,
                         note=note, cut_phase=cut_phase)
            existing = self._by_signature.get(m.signature)
            if existing is not None:
                return self._manifests[existing]
            with open(self._manifest_path(m.version), "w") as f:
                f.write(m.to_json())
            self._manifests[m.version] = m
            self._by_signature[m.signature] = m.version
            return m

    def latest_manifest(self) -> Manifest | None:
        with self._lock:
            if not self._manifests:
                return None
            return self._manifests[max(self._manifests)]

    def manifest(self, version: int) -> Manifest:
        with self._lock:
            return self._manifests[version]

    @property
    def versions(self) -> list:
        with self._lock:
            return sorted(self._manifests)

    # -- serving pointer -----------------------------------------------
    @property
    def serving_version(self) -> int | None:
        with self._lock:
            self._refresh_locked()
            return self._serving

    @property
    def promotion_history(self) -> list:
        """Versions on the rollback stack (previously serving)."""
        with self._lock:
            self._refresh_locked()
            return list(self._history)

    def promote(self, version: int) -> None:
        """Atomically tag ``version`` as serving (the previous one goes
        on the rollback history).  If the pointer write dies mid-promote
        the in-memory state is restored to match the on-disk pointer, so
        a surviving process never serves a version the pointer does not
        record."""
        with self._lock:
            if version not in self._manifests:
                raise KeyError(f"unknown version {version}; "
                               f"registered: {self.versions}")
            if version == self._serving:
                return
            prev_serving, prev_history = self._serving, list(self._history)
            if self._serving is not None:
                self._history.append(self._serving)
            self._serving = version
            try:
                self._fault("promote:pre_pointer")
                self._write_pointer_locked()
            except BaseException:
                self._serving, self._history = prev_serving, prev_history
                raise

    def rollback(self) -> int:
        """Atomically restore the previously serving version."""
        with self._lock:
            if not self._history:
                raise RuntimeError("no version to roll back to")
            prev_serving, prev_history = self._serving, list(self._history)
            self._serving = self._history.pop()
            try:
                self._fault("rollback:pre_pointer")
                self._write_pointer_locked()
            except BaseException:
                self._serving, self._history = prev_serving, prev_history
                raise
            return self._serving

    def serving(self):
        """Atomic (version, path_params_list) snapshot for engines."""
        with self._lock:
            self._refresh_locked()
            if self._serving is None:
                raise RuntimeError(
                    "registry has no serving version; promote one first")
            return self._serving, self.materialize(self._serving)

    def serving_paths(self) -> list:
        return self.serving()[1]

    # -- materialization -----------------------------------------------
    def _payload_locked(self, ref: ModuleRef):
        tree = self._payload_cache.get(ref.digest)
        if tree is not None:
            return tree
        base = self._base[ref.module_id]
        if ref.file is None:
            tree = base
        else:
            try:
                # K>1 phase-complete rows are params-only (momentum stays
                # in the training plane's per-fragment slice rows)
                tree = load_tree(ref.file, {"params": base})["params"]
            except ValueError:
                # the K=1 full row: params + momentum
                like = {"params": base, "momentum": _momentum_like(base)}
                tree = load_tree(ref.file, like)["params"]
        self._payload_cache[ref.digest] = tree
        return tree

    def materialize(self, version: int) -> list:
        """Assemble the full path parameter list for ``version``.

        Each module payload is loaded once (digest cache) and reused by
        every path that routes through it; the assembled list is
        memoized by manifest signature, so re-materializing a version —
        including after a rollback — returns the same tensors.
        """
        with self._lock:
            m = self._manifests[version]
            sig = m.signature
            cached = self._assembled.get(sig)
            if cached is not None:
                return cached
            for ref in m.refs:
                tree = self._payload_locked(ref)
                if ref.module_id == SHARED_ID:
                    self._store.set_shared(tree)
                else:
                    self._store.set_module(ref.level, ref.expert, tree)
            paths = [self._store.assemble(p)
                     for p in range(self.num_paths)]
            self._assembled[sig] = paths
            self._prune_locked()
            return paths

    def _prune_locked(self) -> None:
        keep = set()
        if self._serving is not None:
            keep.add(self._manifests[self._serving].signature)
        while len(self._assembled) > max(self.max_cached_versions, 1):
            victim = next((s for s in self._assembled if s not in keep),
                          None)
            if victim is None:
                break
            del self._assembled[victim]
        # the payload cache shrinks with the assembled cache: every
        # published phase mints fresh digests.  Keep the digests of the
        # manifests whose assembly is still cached (base digests cost
        # nothing — they alias the construction-time template).
        live = set(self._base_digest.values())
        for m in self._manifests.values():
            if m.signature in self._assembled:
                live.update(r.digest for r in m.refs)
        for digest in [d for d in self._payload_cache if d not in live]:
            del self._payload_cache[digest]
