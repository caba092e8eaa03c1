"""The measured window's host: set-up's objects kept out of the cyclic
collector's reach, and what the host did meanwhile.

``Window`` is a context around the measured window.  On entry it runs a
full collection and moves every object made in set-up out of the
collector's reach (``gc.freeze``), so that the window's collections
scan only the window's objects.  The collector stays on: the port's
training step leaves reference cycles that hold device memory, and
without collections a 2x2 run fills the card within a minute.  Over the
window it reads the seconds spent in collections and their count by
generation, the process's CPU time (user and system) as a share of the
wall time, the involuntary context switches, and the share of all CPUs'
time that the hypervisor gave to others (``steal`` in ``/proc/stat``):
the readings that tell a slow host from a slow program.  ``line()``
prints them.
"""
from __future__ import annotations

import gc
import resource
import time


def cpu_ticks():
    """(steal, total) clock ticks of all CPUs so far, or None where
    ``/proc/stat`` cannot be read."""
    try:
        with open("/proc/stat") as f:
            vals = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None
    return (vals[7] if len(vals) > 7 else 0), sum(vals)


class Window:
    def __init__(self):
        self.readings: dict = {}
        self.gc_s, self.gc_count = 0.0, [0, 0, 0]
        self._gc_t0 = None

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_count[info["generation"]] += 1
            self._gc_t0 = None

    def __enter__(self) -> "Window":
        gc.collect()
        gc.freeze()
        gc.callbacks.append(self._on_gc)
        self._ticks = cpu_ticks()
        self._usage = resource.getrusage(resource.RUSAGE_SELF)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        wall = time.perf_counter() - self._t0
        usage = resource.getrusage(resource.RUSAGE_SELF)
        ticks = cpu_ticks()
        gc.callbacks.remove(self._on_gc)
        cpu = (usage.ru_utime - self._usage.ru_utime
               + usage.ru_stime - self._usage.ru_stime)
        self.readings = {
            "wall_s": wall, "cpu_share": cpu / wall,
            "gc_s": self.gc_s, "gc_by_generation": list(self.gc_count),
            "nivcsw": usage.ru_nivcsw - self._usage.ru_nivcsw}
        if ticks is not None and self._ticks is not None \
                and ticks[1] > self._ticks[1]:
            self.readings["steal_share"] = \
                (ticks[0] - self._ticks[0]) / (ticks[1] - self._ticks[1])

    def line(self, **more) -> str:
        """One line of the window's host readings and ``more``."""
        parts = [f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                 for k, v in {**self.readings, **more}.items()]
        return "host: " + ", ".join(parts)
