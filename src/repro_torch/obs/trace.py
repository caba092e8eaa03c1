"""Crash-safe JSONL span/event tracer.

File format — one JSON object per line, four record kinds:

- ``{"k": "hdr", "epoch": E, "pid", "tid", "wall", "mono", "meta"}``
  written once per writing process, first thing after open.  It
  anchors that process's monotonic clock (``mono``, ns) to wall time
  (``wall``, s) so the exporter can place records from different
  processes / resumed runs on one absolute timeline.  ``epoch``
  counts prior headers in the file: a resumed run appends a new
  header with ``epoch + 1`` rather than truncating history.
- ``{"k": "span", "name", "t0", "t1", "pid", "tid", "args"}`` —
  a completed duration (monotonic ns).
- ``{"k": "ev", "name", "t", "pid", "tid", "args"}`` — instant event.
- ``{"k": "ctr", "t", "pid", "tid", "values"}`` — metric sample.

Crash safety: the file is opened in unbuffered binary append mode, so
every drain is a single ``write()`` of whole lines — a ``kill -9``
leaves at most one torn trailing line, and every record before it
stays parseable.  On append-reopen the writer seals a torn tail with
a newline before writing its header.

Hot path: ``emit`` encodes the record and appends the line to a
``deque`` — GIL-atomic, no lock.  Lines reach the file on explicit
``flush()`` (service/publisher/engine call it at safe points, never
under their locks) or when the buffer crosses ``flush_every`` lines.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["TraceWriter", "read_trace", "validate_trace"]

from collections import deque

_DEFAULT_FLUSH_EVERY = 512


class _Span:
    """Context manager recording one complete span on ``__exit__``."""

    __slots__ = ("_writer", "name", "args", "t0")

    def __init__(self, writer, name, args):
        self._writer = writer
        self.name = name
        self.args = args

    def set(self, **kv):
        self.args.update(kv)

    def __enter__(self):
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._writer.emit_span(self.name, self.t0, time.monotonic_ns(),
                               self.args)
        return False


class TraceWriter:
    def __init__(self, path, *, meta=None, fresh=False, flush_every=None):
        self.path = os.fspath(path)
        self.flush_every = (_DEFAULT_FLUSH_EVERY if flush_every is None
                            else max(1, int(flush_every)))
        self._buf = deque()
        self._io_lock = threading.Lock()
        self._closed = False
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        epoch, seal = 0, False
        if not fresh and os.path.exists(self.path):
            epoch, seal = self._scan_existing()
        mode = "wb" if fresh else "ab"
        # buffering=0: each drain is one write() of whole lines, so a
        # kill leaves at most a single torn trailing line
        self._fh = open(self.path, mode, buffering=0)
        if seal:
            self._fh.write(b"\n")  # seal a torn tail from a prior crash
        self.epoch = epoch
        hdr = {
            "k": "hdr",
            "epoch": epoch,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "wall": time.time(),
            "mono": time.monotonic_ns(),
            "meta": meta or {},
        }
        self._fh.write(json.dumps(hdr).encode() + b"\n")

    def _scan_existing(self):
        """Count prior headers; report whether the tail line is torn."""
        epochs = 0
        seal = False
        with open(self.path, "rb") as fh:
            data = fh.read()
        if data:
            seal = not data.endswith(b"\n")
            for line in data.splitlines():
                if b'"k": "hdr"' in line or b'"k":"hdr"' in line:
                    epochs += 1
        return epochs, seal

    # -- hot path ---------------------------------------------------
    # analysis: lockfree(deque.append is GIL-atomic; drained under _io_lock by flush)
    def _emit(self, rec):
        self._buf.append(json.dumps(rec).encode() + b"\n")
        if len(self._buf) >= self.flush_every:
            self.flush()

    def emit_span(self, name, t0_ns, t1_ns, args=None):
        self._emit({
            "k": "span", "name": name, "t0": t0_ns, "t1": t1_ns,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args or {},
        })

    def span(self, name, **args):
        return _Span(self, name, args)

    def instant(self, name, **args):
        self._emit({
            "k": "ev", "name": name, "t": time.monotonic_ns(),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args,
        })

    def counters(self, values):
        self._emit({
            "k": "ctr", "t": time.monotonic_ns(),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "values": values,
        })

    # -- cold path --------------------------------------------------
    def flush(self):
        """Drain buffered lines to disk.  Never call while holding a
        subsystem lock — this does file IO (enforced by the LCK301
        blocking-under-lock analysis entry)."""
        lines = []
        while True:
            try:
                lines.append(self._buf.popleft())
            except IndexError:
                break
        if not lines:
            return
        with self._io_lock:
            if self._closed:
                return
            self._fh.write(b"".join(lines))

    def close(self):
        self.flush()
        with self._io_lock:
            if not self._closed:
                self._closed = True
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- readers --------------------------------------------------------

_REQUIRED = {
    "hdr": ("epoch", "pid", "wall", "mono"),
    "span": ("name", "t0", "t1", "pid", "tid"),
    "ev": ("name", "t", "pid", "tid"),
    "ctr": ("t", "pid", "tid", "values"),
}


def read_trace(path):
    """Parse a trace JSONL file.

    Returns ``(records, skipped)`` where ``skipped`` counts
    unparseable lines (torn tails from crashes).  Every complete
    record is returned even when a torn line sits mid-file (a crash
    followed by an append-resume).
    """
    records, skipped = [], 0
    with open(path, "rb") as fh:
        data = fh.read()
    for line in data.splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        records.append(rec)
    return records, skipped


def validate_trace(records):
    """Schema-check records; returns a list of error strings."""
    errors = []
    if not records or records[0].get("k") != "hdr":
        errors.append("trace does not start with a hdr record")
    for i, rec in enumerate(records):
        kind = rec.get("k")
        req = _REQUIRED.get(kind)
        if req is None:
            errors.append(f"record {i}: unknown kind {kind!r}")
            continue
        missing = [f for f in req if f not in rec]
        if missing:
            errors.append(f"record {i} ({kind}): missing {missing}")
        if kind == "span" and not missing and rec["t1"] < rec["t0"]:
            errors.append(f"record {i} (span {rec['name']}): t1 < t0")
    return errors
