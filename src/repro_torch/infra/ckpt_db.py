"""Checkpoint metadata table (the paper's Spanner table, §3 step 2) +
npz checkpoint store (the paper's GFS); the port of
``repro/infra/ckpt_db.py``.  Watchers poll for rows they have not
consumed yet via ``wait_for``; push-style subscribers register a
listener with ``add_listener`` and are called on every committed write.

The DB is the training service's *recovery substrate*: every row is
appended to ``rows.jsonl`` inside the root so a restarted process
reconstructs the table, and a ``max_rows_per_path`` retention policy
garbage-collects old rows + npz files.

The files are the reference's, so either package reads the other's:
``leaf_{i}`` in ``jax.tree_util`` flatten order (``core.pytree``) and
``treedef``, the JSON of the string JAX prints for the tree's structure.
A bfloat16 leaf is written as the reference writes one (numpy has no
bfloat16, so its 16 bits go out as a ``|V2`` array), and ``load_tree``
reads such a leaf back only into a bfloat16 template leaf.

The DB is host-side: ``save_tree`` moves every device leaf to the host
and ``load_tree`` moves each leaf to its template's device.  Both count
the bytes they move and the seconds they take (``io_stats``).
"""
from __future__ import annotations

import json
import os
import threading
import time
import zipfile
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from repro_torch.core import pytree

# how numpy holds the raw 16 bits of a bfloat16 leaf read from a file,
# and the descr the reference's files give it (ml_dtypes' bfloat16)
_BF16_ON_DISK = np.dtype("V2")
_BF16_DESCR = "<V2"

_io_lock = threading.Lock()
_IO_KEYS = ("rows_written", "d2h_bytes", "d2h_s", "write_s",
            "file_bytes", "rows_read", "h2d_bytes", "read_s", "h2d_s")
_io = dict.fromkeys(_IO_KEYS, 0)


def io_stats() -> dict:
    """Bytes moved and seconds spent by ``save_tree`` (device to host,
    then the file write; ``file_bytes``, the files' sizes) and
    ``load_tree`` (the file read, then host to device) since the last
    ``reset_io_stats``."""
    with _io_lock:
        return dict(_io)


def reset_io_stats() -> None:
    with _io_lock:
        _io.update(dict.fromkeys(_IO_KEYS, 0))


def _count(**kv) -> None:
    with _io_lock:
        for k, v in kv.items():
            _io[k] += v


def _to_host(x) -> tuple:
    """-> (numpy array, whether it holds bfloat16 bits, device bytes
    moved)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x), False, 0
    t = x.detach()
    moved = t.numel() * t.element_size() if t.device.type != "cpu" else 0
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy(), True, moved
    return t.cpu().numpy(), False, moved


def _savez(file: str, arrays: dict, bf16: set) -> None:
    """``np.savez`` (the same zip members, in the same order), except that
    a bfloat16 leaf's header carries the reference's ``<V2`` descr over
    its 16-bit payload."""
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if key in bf16:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": _BF16_DESCR, "fortran_order": False,
                              "shape": val.shape})
                    fid.write(np.ascontiguousarray(val).tobytes())
                else:
                    np.lib.format.write_array(fid, np.asanyarray(val),
                                              allow_pickle=False)


def _template_dtype(ref) -> str | np.dtype:
    if isinstance(ref, torch.Tensor):
        if ref.dtype == torch.bfloat16:
            return "bfloat16"
        return torch.empty(0, dtype=ref.dtype).numpy().dtype
    return np.dtype(getattr(ref, "dtype", None) or np.result_type(ref))


@dataclass
class CkptRow:
    path_id: int
    phase: int
    step: int
    file: str
    kind: str = "train"     # train | opt | snap | module | qres | flush | fleet
    level: int = -1              # kind="module": which executor wrote it
    expert: int = -1             # (-1, -1) = the shared-leaves executor
    fragment: int = -1           # kind="module": which fragment window
    extra: dict = field(default_factory=dict)
    ts: float = field(default_factory=time.time)


def save_tree(file: str, tree) -> None:
    flat, treedef = pytree.flatten(tree)
    os.makedirs(os.path.dirname(file) or ".", exist_ok=True)
    if not file.endswith(".npz"):
        file += ".npz"          # as np.savez names it
    t0 = time.perf_counter()
    arrays = {"treedef": json.dumps(str(treedef))}
    bf16, moved = set(), 0
    for i, x in enumerate(flat):
        arrays[f"leaf_{i}"], is_bf16, n = _to_host(x)
        if is_bf16:
            bf16.add(f"leaf_{i}")
        moved += n
    t1 = time.perf_counter()
    _savez(file, arrays, bf16)
    _count(rows_written=1, d2h_bytes=moved, d2h_s=t1 - t0,
           write_s=time.perf_counter() - t1, file_bytes=os.path.getsize(file))


def _read_leaves(file: str, data, flat, treedef) -> list:
    """The file's leaves as numpy arrays, checked against the template's
    leaves ``flat`` and structure ``treedef`` as the reference checks."""
    n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
    if n_saved != len(flat):
        raise ValueError(
            f"checkpoint {file} holds {n_saved} leaves but the template "
            f"tree has {len(flat)} — wrong `like` tree for this file")
    if "treedef" in data.files:
        saved = json.loads(str(np.asarray(data["treedef"]).item()))
        if saved != str(treedef):
            raise ValueError(
                f"checkpoint {file} treedef mismatch:\n"
                f"  saved:    {saved}\n  template: {treedef}")
    host = []
    for i, ref in enumerate(flat):
        leaf = data[f"leaf_{i}"]
        if tuple(leaf.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint {file} leaf_{i} has shape {leaf.shape}, "
                f"template expects {tuple(ref.shape)}")
        want = _template_dtype(ref)
        ok = (leaf.dtype == _BF16_ON_DISK if isinstance(want, str)
              else np.dtype(leaf.dtype) == want)
        if not ok:
            raise ValueError(
                f"checkpoint {file} leaf_{i} has dtype {leaf.dtype}, "
                f"template expects {want} — loading would silently "
                f"reinterpret the payload (e.g. a float32 row into an "
                f"int8-quantized slot); use a template with matching "
                f"dtypes")
        host.append(leaf)
    return host


def load_tree(file: str, like):
    """Load a tree saved by ``save_tree`` (by either package), validated
    against ``like``: treedef, leaf count, per-leaf shapes and dtypes
    must match.  Tensor leaves land on the device of their template
    leaf."""
    t0 = time.perf_counter()
    flat, treedef = pytree.flatten(like)
    with np.load(file) as data:
        host = _read_leaves(file, data, flat, treedef)
    t1 = time.perf_counter()
    loaded, moved = [], 0
    for leaf, ref in zip(host, flat):
        if not isinstance(ref, torch.Tensor):
            loaded.append(leaf)
            continue
        if ref.dtype == torch.bfloat16:
            t = torch.from_numpy(np.ascontiguousarray(leaf).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(leaf).copy())
        if ref.device.type != "cpu":
            moved += t.numel() * t.element_size()
        loaded.append(t.to(ref.device))
    _count(rows_read=1, read_s=t1 - t0, h2d_bytes=moved,
           h2d_s=time.perf_counter() - t1)
    return treedef.unflatten(loaded)


class CheckpointDB:
    def __init__(self, root: str, *, max_rows_per_path: int | None = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.max_rows_per_path = max_rows_per_path
        self._lock = threading.Condition()
        self._rows: list = []
        self._listeners: list = []
        self.listener_errors = 0
        self._log = os.path.join(root, "rows.jsonl")
        if os.path.exists(self._log):
            with open(self._log) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = CkptRow(**json.loads(line))
                    if os.path.exists(row.file):
                        self._rows.append(row)

    @staticmethod
    def _group(row: CkptRow):
        # per-fragment retention: each fragment window's rows get their
        # own budget (a K-fragment module writes K× the rows)
        return (row.kind, row.path_id, row.level, row.expert, row.fragment)

    def write(self, tree, *, path_id: int, phase: int, step: int,
              kind: str = "train", level: int = -1, expert: int = -1,
              fragment: int = -1, extra: dict | None = None) -> CkptRow:
        frag = f"f{fragment}" if fragment >= 0 else ""
        if level >= 0:
            name = f"{kind}_l{level}e{expert}{frag}_ph{phase:04d}_s{step}.npz"
        else:
            name = f"{kind}_p{path_id:04d}{frag}_ph{phase:04d}_s{step}.npz"
        file = os.path.join(self.root, name)
        save_tree(file, tree)
        row = CkptRow(path_id=path_id, phase=phase, step=step, file=file,
                      kind=kind, level=level, expert=expert,
                      fragment=fragment, extra=dict(extra or {}))
        with self._lock:
            self._rows.append(row)
            dropped = self._gc_locked(row) if self.max_rows_per_path else []
            if dropped:
                self._rewrite_log_locked()
            else:
                with open(self._log, "a") as f:
                    f.write(json.dumps(asdict(row)) + "\n")
            self._lock.notify_all()
            listeners = list(self._listeners)
        for r in dropped:
            if r.file != file:     # a retried write may reuse the name
                try:
                    os.remove(r.file)
                except OSError:
                    pass
        # listeners run outside the lock but after the row is committed;
        # a listener failure must not propagate into the writer's thread
        for fn in listeners:
            try:
                fn(row)
            except Exception:  # noqa: BLE001
                self.listener_errors += 1
        return row

    # -- event subscription ---------------------------------------------
    def add_listener(self, fn) -> None:
        """Subscribe ``fn(row)`` to every committed write.  The callback
        runs on the writer's thread; keep it short and never write to
        the DB from inside it."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def _gc_locked(self, row: CkptRow) -> list:
        group = [r for r in self._rows if self._group(r) == self._group(row)]
        if len(group) <= self.max_rows_per_path:
            return []
        if row.kind == "fleet":
            # membership epochs must replay in full
            return []
        if row.kind == "module":
            # resume-replay safety: a module row stays pinned while any
            # train row its apply consumed is still retained
            retained = {(r.path_id, r.phase) for r in self._rows
                        if r.kind == "train"}

            def pinned(r):
                return any((int(w), int(t)) in retained
                           for w, t in r.extra.get("consumed", []))
        else:
            def pinned(r):
                return False
        drop = []
        for r in group[:-1]:          # never drop the just-written row
            if len(group) - len(drop) <= self.max_rows_per_path:
                break
            if not pinned(r):
                drop.append(r)
        dropped = set(map(id, drop))
        self._rows = [r for r in self._rows if id(r) not in dropped]
        return drop

    def _rewrite_log_locked(self) -> None:
        tmp = self._log + ".tmp"
        with open(tmp, "w") as f:
            for r in self._rows:
                f.write(json.dumps(asdict(r)) + "\n")
        os.replace(tmp, self._log)

    def rows(self, *, kind=None, phase=None, path_id=None) -> list:
        with self._lock:
            out = list(self._rows)
        if kind is not None:
            out = [r for r in out if r.kind == kind]
        if phase is not None:
            out = [r for r in out if r.phase == phase]
        if path_id is not None:
            out = [r for r in out if r.path_id == path_id]
        return out

    def wait_for(self, predicate, timeout: float = 60.0):
        """Block until a row matching predicate appears (§3 step 4)."""
        deadline = time.time() + timeout
        with self._lock:
            while True:
                hits = [r for r in self._rows if predicate(r)]
                if hits:
                    return hits
                if time.time() >= deadline:
                    return []
                self._lock.wait(timeout=0.05)

    def nbytes(self) -> int:
        """Bytes of the retained rows' files on disk."""
        return sum(os.path.getsize(r.file) for r in self.rows()
                   if os.path.exists(r.file))

    def to_json(self) -> str:
        with self._lock:
            return json.dumps([asdict(r) for r in self._rows])
