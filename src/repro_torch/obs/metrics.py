"""Typed metric registry: counters, gauges, histograms with labels.

Design contract (PR-8 lock discipline):

- **Hot-path recording is lock-free.**  Every metric keeps one private
  cell per recording thread (``threading.local``).  A thread's first
  touch registers its cell into the metric's shared cell list under the
  registry lock (cold path, once per thread per metric); every later
  ``inc``/``set``/``observe`` mutates only the thread-private cell —
  no lock, no contention, GIL-atomic dict ops.
- **Reads are snapshot-under-lock.**  ``MetricRegistry.snapshot()``
  merges all cells while holding the registry lock, so concurrent
  metric *creation* cannot race the read.  A cell owned by a thread
  that is mid-update may contribute a value that is one record stale;
  callers that need exact totals (e.g. ``TrainingService`` comm
  accounting) perform both the updates and the snapshot under their
  own outer lock, which makes the numbers exact.

Naming convention (documented in README "Observability"):
``plane.component.metric`` — e.g. ``train.comm.send_bytes``,
``serve.engine.ticks``, ``deploy.canary.verdicts``.
"""

from __future__ import annotations

import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry"]

# monotonically increasing stamp so Gauge.snapshot can pick the most
# recent set() across thread cells without any cross-thread ordering
_seq_lock = threading.Lock()
_seq = 0


def _next_seq():
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def _labelkey(labels):
    return tuple(sorted(labels.items())) if labels else ()


def _labelstr(key):
    return ",".join(f"{k}={v}" for k, v in key)


def _bucket(v):
    """Power-of-two upper bound for histogram bucketing (0 for v<=0)."""
    if v <= 0:
        return 0
    n = int(math.ceil(v))
    b = 1
    while b < n:
        b <<= 1
    return b


class _Metric:
    """Shared cell plumbing: one private dict per recording thread."""

    kind = "metric"

    def __init__(self, name, registry_lock):
        self.name = name
        self._lock = registry_lock
        self._cells = []  # all thread cells; appended under self._lock
        self._tl = threading.local()

    def _cell(self):
        cell = getattr(self._tl, "cell", None)
        if cell is None:
            cell = {}
            with self._lock:  # cold path: first touch per thread
                self._cells.append(cell)
            self._tl.cell = cell
        return cell

    def reset_locked(self):
        """Clear all cells in place (caller holds the registry lock)."""
        for cell in self._cells:
            cell.clear()


class Counter(_Metric):
    """Monotonic counter.  ``inc(n, **labels)`` on the hot path."""

    kind = "counter"

    # analysis: lockfree(thread-private cell; merged under the registry lock by snapshot)
    def inc(self, n=1, **labels):
        cell = self._cell()
        key = _labelkey(labels)
        cell[key] = cell.get(key, 0) + n

    def snapshot_locked(self):
        out = {}
        for cell in self._cells:
            for key, v in list(cell.items()):
                out[key] = out.get(key, 0) + v
        return {_labelstr(k): v for k, v in sorted(out.items())}


class Gauge(_Metric):
    """Last-write-wins gauge (cross-thread order via a global stamp)."""

    kind = "gauge"

    # analysis: lockfree(thread-private cell; merged under the registry lock by snapshot)
    def set(self, value, **labels):
        self._cell()[_labelkey(labels)] = (_next_seq(), float(value))

    def snapshot_locked(self):
        out = {}
        for cell in self._cells:
            for key, stamped in list(cell.items()):
                cur = out.get(key)
                if cur is None or stamped[0] > cur[0]:
                    out[key] = stamped
        return {_labelstr(k): v for k, (_, v) in sorted(out.items())}


class Histogram(_Metric):
    """Streaming histogram: count / sum / min / max + pow2 buckets.

    ``observe(v)`` is the hot path.  The per-label state is a mutable
    list ``[count, sum, min, max, {bucket: n}]`` owned by one thread.
    """

    kind = "histogram"

    # analysis: lockfree(thread-private cell; merged under the registry lock by snapshot)
    def observe(self, value, **labels):
        cell = self._cell()
        key = _labelkey(labels)
        st = cell.get(key)
        if st is None:
            st = cell[key] = [0, 0.0, math.inf, -math.inf, {}]
        st[0] += 1
        st[1] += value
        if value < st[2]:
            st[2] = value
        if value > st[3]:
            st[3] = value
        b = _bucket(value)
        st[4][b] = st[4].get(b, 0) + 1

    def snapshot_locked(self):
        out = {}
        for cell in self._cells:
            for key, st in list(cell.items()):
                acc = out.get(key)
                if acc is None:
                    acc = out[key] = [0, 0.0, math.inf, -math.inf, {}]
                acc[0] += st[0]
                acc[1] += st[1]
                acc[2] = min(acc[2], st[2])
                acc[3] = max(acc[3], st[3])
                for b, n in list(st[4].items()):
                    acc[4][b] = acc[4].get(b, 0) + n
        return {
            _labelstr(k): {
                "count": st[0],
                "sum": st[1],
                "min": st[2] if st[0] else 0,
                "max": st[3] if st[0] else 0,
                "buckets": dict(sorted(st[4].items())),
            }
            for k, st in sorted(out.items())
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """Get-or-create metric store with consistent snapshot reads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, name, cls):
        # analysis: lockfree(dict.get is GIL-atomic; creation double-checks under the lock)
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, self._lock)
        if type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self, prefix=""):
        """``{name: {"kind": ..., "values": {labelstr: value}}}``."""
        with self._lock:
            return {
                name: {"kind": m.kind, "values": m.snapshot_locked()}
                for name, m in sorted(self._metrics.items())
                if name.startswith(prefix)
            }

    def flat(self, prefix=""):
        """Flatten a snapshot to ``{name[{labels}]: number}`` for
        counter samples in the trace (histograms contribute their
        ``count``/``sum``/``max`` components)."""
        out = {}
        for name, entry in self.snapshot(prefix).items():
            for lab, v in entry["values"].items():
                base = f"{name}{{{lab}}}" if lab else name
                if entry["kind"] == "histogram":
                    out[f"{base}.count"] = v["count"]
                    out[f"{base}.sum"] = v["sum"]
                    out[f"{base}.max"] = v["max"]
                else:
                    out[base] = v
        return out

    def reset(self, prefix=""):
        """Zero matching metrics in place (benchmark warmup boundary)."""
        with self._lock:
            for name, m in self._metrics.items():
                if name.startswith(prefix):
                    m.reset_locked()
