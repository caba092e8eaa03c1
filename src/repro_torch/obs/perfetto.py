"""Chrome/Perfetto ``trace_event`` JSON exporter.

Converts a repro JSONL trace into the `trace_event format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
understood by https://ui.perfetto.dev and ``chrome://tracing``:

- ``span``  → ``ph="X"`` complete events (``ts``/``dur`` in µs)
- ``ev``    → ``ph="i"`` instant events (thread scope)
- ``ctr``   → ``ph="C"`` counter events
- ``hdr``   → process/thread ``M`` metadata + the clock anchor used
  to map each epoch's monotonic nanoseconds onto absolute wall-clock
  microseconds, so resumed runs line up on one timeline.
"""

from __future__ import annotations

import json

from .trace import read_trace

__all__ = ["export_perfetto", "to_trace_events"]


class _Anchor:
    __slots__ = ("wall_us", "mono_ns")

    def __init__(self, hdr):
        self.wall_us = hdr["wall"] * 1e6
        self.mono_ns = hdr["mono"]

    def ts(self, mono_ns):
        return self.wall_us + (mono_ns - self.mono_ns) / 1e3


def to_trace_events(records):
    """Convert parsed JSONL records to a ``traceEvents`` list."""
    events = []
    anchors = {}  # pid -> most recent _Anchor (per epoch header)
    seen_pids = set()
    for rec in records:
        kind = rec.get("k")
        pid = rec.get("pid", 0)
        if kind == "hdr":
            anchors[pid] = anchor = _Anchor(rec)
            meta = rec.get("meta") or {}
            if pid not in seen_pids:
                seen_pids.add(pid)
                name = meta.get("suite") or meta.get("name") or "repro"
                events.append({
                    "ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0, "args": {"name": f"{name} (pid {pid})"},
                })
            events.append({
                "ph": "i", "name": f"epoch {rec['epoch']}",
                "pid": pid, "tid": rec.get("tid", 0), "s": "p",
                "ts": anchor.ts(rec["mono"]), "args": meta,
            })
            continue
        anchor = anchors.get(pid)
        if anchor is None:
            continue  # records before any header for this pid
        tid = rec.get("tid", 0)
        if kind == "span":
            events.append({
                "ph": "X", "name": rec["name"], "pid": pid, "tid": tid,
                "ts": anchor.ts(rec["t0"]),
                "dur": max(0.001, (rec["t1"] - rec["t0"]) / 1e3),
                "args": rec.get("args") or {},
            })
        elif kind == "ev":
            events.append({
                "ph": "i", "name": rec["name"], "pid": pid, "tid": tid,
                "s": "t", "ts": anchor.ts(rec["t"]),
                "args": rec.get("args") or {},
            })
        elif kind == "ctr":
            ts = anchor.ts(rec["t"])
            for name, value in sorted((rec.get("values") or {}).items()):
                events.append({
                    "ph": "C", "name": name, "pid": pid, "tid": 0,
                    "ts": ts, "args": {"value": value},
                })
    return events


def export_perfetto(trace_path, out_path):
    """Read a JSONL trace and write Perfetto-loadable JSON.

    Returns ``(num_events, skipped_lines)``.
    """
    records, skipped = read_trace(trace_path)
    events = to_trace_events(records)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
    return len(events), skipped
