"""repro_torch.obs — unified telemetry plane (a copy of the JAX package's
``repro.obs``, which is stdlib only; the port imports nothing of it).

One nullable handle (``Telemetry``) threads through every subsystem:
the training service, transport, fleet/chaos controllers, worker
pool, deploy publisher, and serving engine all accept
``telemetry=None`` and pay nothing when it is absent (``NULL`` is a
shared no-op whose ``span`` returns a singleton context manager).

Enabled, it provides:

- ``span(name, **args)`` / ``instant(name, **args)`` — structured
  spans and events into a crash-safe JSONL trace (``trace.py``),
- a typed :class:`~repro_torch.obs.metrics.MetricRegistry` (``.metrics``)
  with lock-free hot-path recording,
- ``sample_metrics()`` — snapshot the registry into the trace as a
  counter record,
- exporters: Chrome/Perfetto ``trace_event`` JSON (``perfetto.py``)
  and a summary CLI (``python -m repro_torch.obs``).

Span/event name vocabulary (``plane.component``):

======================  ============================================
``train.phase``         one shard×phase inner-loop execution
``train.fragment_send`` one fragment slot shipped on the wire
``train.run``           one ``TrainingService.run`` window
``transport.ship``      mesh transport device round-trip
``transport.retry``     instant: a send attempt failed and backed off
``fleet.epoch``         instant: membership epoch commit
``fleet.chaos``         instant: chaos controller action
``pool.task``           worker-pool task execution
``pool.preempt``        instant: simulated worker preemption
``pool.restart``        instant: monitor restarted dead workers
``deploy.cycle``        one publisher publish cycle
``deploy.canary``       canary gate evaluation
``deploy.promote`` / ``deploy.reject`` / ``deploy.rollback``  instants
``serve.tick``          one continuous-batching engine step
``serve.swap``          engine hot-swap window (drain start→install)
``serve.admit``         instant: request admitted to a slot
``serve.preempt``       instant: high-priority admit evicted a
                        preemptible slot (evictee re-queues)
``serve.route``         instant: fleet front door dispatched a request
``serve.rebalance``     instant: fleet recomputed per-path replicas
======================  ============================================
"""

from __future__ import annotations

import time

from .metrics import Counter, Gauge, Histogram, MetricRegistry
from .trace import TraceWriter, read_trace, validate_trace

__all__ = [
    "NULL",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "NullTelemetry",
    "Telemetry",
    "TraceWriter",
    "as_telemetry",
    "read_trace",
    "validate_trace",
]


class _NullSpan:
    """Singleton no-op span: zero allocation on the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kv):
        pass


_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """Disabled telemetry: every call is a no-op.

    ``metrics`` is ``None`` — subsystems that need a registry even
    without tracing (e.g. the service's comm accounting) create their
    own private :class:`MetricRegistry` when they see ``None``.
    """

    __slots__ = ()

    enabled = False
    metrics = None
    path = None
    trace = None

    def span(self, name, **args):
        return _NULL_SPAN

    def complete_span(self, name, t0_ns, **args):
        pass

    def instant(self, name, **args):
        pass

    def sample_metrics(self, prefix=""):
        pass

    def flush(self):
        pass

    def close(self):
        pass


NULL = NullTelemetry()


class Telemetry:
    """Live telemetry handle: a trace writer + a metric registry.

    ``path=None`` keeps the registry but drops all trace records —
    metrics-only mode with the same API.
    """

    enabled = True

    def __init__(self, path=None, *, meta=None, registry=None,
                 fresh=False, flush_every=None):
        self.path = None if path is None else str(path)
        self.metrics = registry if registry is not None else MetricRegistry()
        self.trace = (
            TraceWriter(path, meta=meta, fresh=fresh,
                        flush_every=flush_every)
            if path is not None else None
        )

    @property
    def epoch(self):
        return self.trace.epoch if self.trace is not None else 0

    def span(self, name, **args):
        if self.trace is None:
            return _NULL_SPAN
        return self.trace.span(name, **args)

    def complete_span(self, name, t0_ns, **args):
        """Record a span whose start was captured earlier (e.g. an
        engine swap window opened ticks ago)."""
        if self.trace is not None:
            self.trace.emit_span(name, t0_ns, time.monotonic_ns(), args)

    def instant(self, name, **args):
        if self.trace is not None:
            self.trace.instant(name, **args)

    def sample_metrics(self, prefix=""):
        if self.trace is not None:
            values = self.metrics.flat(prefix)
            if values:
                self.trace.counters(values)

    def flush(self):
        """Drain the trace buffer.  File IO — never call under a
        subsystem lock (LCK301 enforces this)."""
        if self.trace is not None:
            self.trace.flush()

    def close(self):
        if self.trace is not None:
            self.sample_metrics()
            self.trace.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def as_telemetry(telemetry):
    """Normalize a nullable handle: ``None`` → the shared ``NULL``."""
    return NULL if telemetry is None else telemetry
