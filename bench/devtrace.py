"""Reading the device trace of a ``--trace 1`` run: torch.profiler with
CUDA activity alone (kernels, copies, sets), over a slice of ``SLICE_S``
seconds that the drivers run after the measured window, so that the
window's host-clock numbers are those of an untraced run.

The profiler records no host operations: with them a host-bound step
ran 80% slower (937 ms against 520 for ``train-150m-2x2``'s step of
all workers), and the idle share read the profiler's cost.  What the
host was doing comes from the drivers' own ``span``s, kept on the host
clock and moved onto the trace's clock by a marker kernel launched
right after a synchronize.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

SLICE_S = 10.0      # seconds the profiler records
MARKER = "spin_kernel"          # ``torch.cuda._sleep``'s kernel
_ACTIVE = []                    # the Slice recording, if any


def device_sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str):
    """A host range named ``name``, kept while a slice records."""
    if not _ACTIVE:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        if _ACTIVE:
            _ACTIVE[0].spans.append((name, t0, time.perf_counter_ns()))


class Slice:
    """The profiler over one slice.  Made before the slice, where it
    prepares its tracing (the profiler's warm-up, work that would
    otherwise stall the slice); ``begin()`` starts recording and
    ``end()`` stops it, each after a synchronize.  ``window_s`` is the
    slice's host-clock length; ``read()`` its ``DeviceTrace``."""

    def __init__(self):
        act = torch.profiler.ProfilerActivity
        # without a card (the CPU tests) the host's, which hold no
        # device operation: the device metrics then have no reading
        self.prof = torch.profiler.profile(
            activities=[act.CUDA if torch.cuda.is_available() else act.CPU],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1))
        self.prof.start()
        self.t0, self.window_s, self.trace = None, 0.0, None
        self.done, self.spans, self.marker_ns = False, [], None

    @property
    def on(self) -> bool:
        return self.t0 is not None and not self.done

    def begin(self) -> None:
        if self.t0 is None:
            device_sync()
            self.prof.step()
            device_sync()
            self.marker_ns = time.perf_counter_ns()
            if torch.cuda.is_available():
                torch.cuda._sleep(1)
            self.t0 = time.perf_counter()
            _ACTIVE[:] = [self]

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0 if self.on else 0.0

    def end(self) -> None:
        if self.done:
            return
        device_sync()
        _ACTIVE[:] = []
        if self.t0 is not None:
            self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.done = True

    def read(self):
        """-> the slice's ``DeviceTrace`` (None if it never began)."""
        self.end()
        if self.trace is None and self.t0 is not None:
            self.trace = DeviceTrace.from_profile(self.prof, self.spans,
                                                  self.marker_ns)
        return self.trace


@dataclass
class DeviceTrace:
    ops: list = field(default_factory=list)     # (name, t0 ns, t1 ns)
    notes: list = field(default_factory=list)   # host spans, trace clock

    @classmethod
    def from_profile(cls, prof, spans=(), marker_ns=None) -> "DeviceTrace":
        """The device operations of ``prof``, and the host ``spans``
        (perf_counter ns) moved onto the trace's clock by the marker
        kernel launched at ``marker_ns``."""
        cuda = torch.autograd.DeviceType.CUDA
        out, marker = cls(), None
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.is_user_annotation():
                continue
            t0 = e.start_ns()
            if MARKER in e.name():
                marker = t0 if marker is None else min(marker, t0)
                continue
            out.ops.append((e.name(), t0, t0 + e.duration_ns()))
        out.ops.sort(key=lambda x: x[1])
        if marker is not None and marker_ns is not None:
            shift = marker - marker_ns
            out.notes = [(n, a + shift, b + shift) for n, a, b in spans]
        return out

    def merged(self) -> list:
        """The union of the device intervals, as sorted (t0, t1)."""
        spans = []
        for _, t0, t1 in self.ops:
            if spans and t0 <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], t1)
            else:
                spans.append([t0, t1])
        return spans

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(t1 - t0 for t0, t1 in self.merged()) / 1e9

    def kernel_time(self, match) -> tuple:
        """(seconds, launches) of the device operations whose name
        ``match(name)`` accepts."""
        hits = [t1 - t0 for name, t0, t1 in self.ops if match(name)]
        return sum(hits) / 1e9, len(hits)

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the operations that took most device
        time, summed by name."""
        by = {}
        for name, t0, t1 in self.ops:
            by[name] = by.get(name, 0) + (t1 - t0)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds]]: the device's idle gaps
        between its first and last operation, summed by the innermost
        ``bench.*`` range open at each gap's midpoint."""
        spans = self.merged()
        notes = sorted(self.notes, key=lambda n: n[1])
        by, active, j = {}, [], 0
        for (_, a), (b, _) in zip(spans, spans[1:]):
            mid = (a + b) / 2
            while j < len(notes) and notes[j][1] <= mid:
                active.append(notes[j])
                j += 1
            active = [n for n in active if n[2] >= mid]
            label = min(active, key=lambda n: n[2] - n[1])[0] if active \
                else "outside bench ranges"
            by[label] = by.get(label, 0) + (b - a)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]
