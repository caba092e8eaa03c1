"""Request admission + per-path queues for the continuous-batching engine.

A copy of the JAX package's ``repro/serving/scheduler.py`` (numpy only;
the port imports nothing of the JAX package).

Requests enter a global admission queue, are routed once (prefix
features -> path, paper §2.4.2) and then wait in their path island's
queue until the island's slot arena has a free slot (backpressure).
The scheduler is deliberately host-side and tick-synchronous: the
engine calls :meth:`admissions` once per tick and gets, per path, the
batch of requests to prefill this tick.

Priority classes (serving fleet): every request carries a priority
class — ``PRIO_HIGH`` (0, interactive), ``PRIO_STANDARD`` (1, the
default) and ``PRIO_PREEMPTIBLE`` (2, batch work whose slot a
high-priority admit may evict).  Each path island keeps one FIFO queue
per class and admissions drain strictly by class, so a batch job can
never starve an interactive request waiting on the same island.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# priority classes (lower value = more urgent)
PRIO_HIGH = 0          # interactive: may preempt a preemptible slot
PRIO_STANDARD = 1      # default
PRIO_PREEMPTIBLE = 2   # batch: runs on spare slots, evictable
_PRIORITIES = (PRIO_HIGH, PRIO_STANDARD, PRIO_PREEMPTIBLE)


@dataclass
class Request:
    """One generation request."""
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int
    arrival: float = 0.0          # trace timestamp (seconds)
    priority: int = PRIO_STANDARD
    # pre-routed path id (serving-fleet front door routes by path
    # affinity before dispatching to an engine); None = route on admit
    path: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.priority not in _PRIORITIES:
            raise ValueError(
                f"request {self.rid}: priority must be one of "
                f"{_PRIORITIES}, got {self.priority}")


@dataclass
class RequestState:
    """Engine-internal in-flight state for an admitted request."""
    req: Request
    path: int
    slot: int
    tokens: List[int]             # prompt + generated so far
    next_logits: Optional[np.ndarray] = None  # predicts tokens[len(tokens)]
    switches: int = 0
    prefilled_this_tick: bool = False
    admitted_at: float = 0.0
    version: int = -1             # registry version admitted under
    swapped_midstream: bool = False   # a live hot-swap hit this request
    first_token_at: Optional[float] = None
    preemptions: int = 0          # times this request lost its slot

    @property
    def emitted(self) -> int:
        return len(self.tokens) - len(self.req.prompt)

    @property
    def done(self) -> bool:
        return self.emitted >= self.req.max_new


@dataclass
class SchedulerStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    # total starved *requests* summed over ticks (a tick that leaves 3
    # requests waiting on slots adds 3) — the fleet autoscaler's
    # per-path backpressure signal, broken down in starved_by_path
    backpressure_ticks: int = 0
    starved_by_path: Dict[int, int] = field(default_factory=dict)
    preemptions: int = 0

    def count_starved(self, by_path: Dict[int, int]) -> None:
        for p, n in by_path.items():
            if n:
                self.backpressure_ticks += int(n)
                self.starved_by_path[p] = \
                    self.starved_by_path.get(p, 0) + int(n)


class Scheduler:
    """FIFO-per-class admission queue + per-path wait queues with slot
    backpressure."""

    def __init__(self, num_paths: int):
        self.num_paths = num_paths
        self._arrivals: deque = deque()
        # path -> priority class -> FIFO
        self._path_queues: Dict[int, Dict[int, deque]] = {
            p: {c: deque() for c in _PRIORITIES}
            for p in range(num_paths)}
        self.stats = SchedulerStats()

    def submit(self, req: Request) -> None:
        self.stats.submitted += 1
        self._arrivals.append(req)

    @property
    def pending(self) -> int:
        return (len(self._arrivals)
                + sum(len(q) for cq in self._path_queues.values()
                      for q in cq.values()))

    def queued(self, path: int, priority: Optional[int] = None) -> int:
        """Requests waiting on ``path`` (optionally of one class)."""
        cq = self._path_queues[path]
        if priority is not None:
            return len(cq[priority])
        return sum(len(q) for q in cq.values())

    def route_arrivals(self, route_fn) -> None:
        """Assign every queued arrival to a path island.

        A pre-routed request (``req.path`` set by the fleet front door)
        keeps its assignment; otherwise
        route_fn: (prompt (S,) int32) -> int path id.
        """
        while self._arrivals:
            req = self._arrivals.popleft()
            p = req.path if req.path is not None \
                else int(route_fn(req.prompt))
            self._path_queues[p][req.priority].append(req)

    def requeue(self, req: Request, path: int) -> None:
        """Put a preempted request back at the head of its class queue
        on ``path`` — it re-admits (via the §2.4.3 re-prefill migration
        path) as soon as its island frees a slot, ahead of later
        arrivals of the same class."""
        self._path_queues[path][req.priority].appendleft(req)

    def admissions(self, free_slots_per_path) -> Dict[int, List[Request]]:
        """Pop up to ``free_slots_per_path[p]`` requests per path, in
        strict priority-class order within each path.

        Requests left waiting because their island is out of slots are
        counted as backpressure: ``stats.backpressure_ticks`` advances
        by the number of starved *requests* this tick, per path in
        ``stats.starved_by_path`` (the fleet autoscaler's signal).
        """
        out: Dict[int, List[Request]] = {}
        starved: Dict[int, int] = {}
        for p, cq in self._path_queues.items():
            budget = int(free_slots_per_path.get(p, 0))
            batch = []
            for c in _PRIORITIES:
                q = cq[c]
                while q and len(batch) < budget:
                    batch.append(q.popleft())
            starved[p] = sum(len(q) for q in cq.values())
            if batch:
                self.stats.admitted += len(batch)
                out[p] = batch
        self.stats.count_starved(starved)
        return out

    def drain_backpressure(self) -> None:
        """Count a drain-pause tick (admissions suspended for a pending
        hot swap): every queued request is starved this tick."""
        self.stats.count_starved(
            {p: sum(len(q) for q in cq.values())
             for p, cq in self._path_queues.items()})

    def record_completion(self, n: int = 1) -> None:
        self.stats.completed += n


def prefix_hash_router(num_paths: int, prefix_len: int = 8):
    """Deterministic prompt-hash routing over ``num_paths`` islands.

    Spreads a trace identically for every engine without training a
    router — the standard route_fn for benchmarks, demos and the CLI
    (token-identity comparisons across engines stay meaningful).
    """
    def route(prompt) -> int:
        return int(np.asarray(prompt[:prefix_len], np.int64).sum()) \
            % num_paths
    return route


def poisson_trace(n: int, *, rate: float, prompt_lens, max_new: int,
                  vocab_size: int, seed: int = 0, corpus=None,
                  priorities=None) -> List[Request]:
    """Sample ``n`` requests with Poisson arrivals and mixed prompt lengths.

    prompt_lens: sequence of lengths sampled uniformly (a few discrete
    buckets keeps the number of prefill compilations bounded).  Prompts
    come from ``corpus.sample_documents`` when given, else uniform
    random tokens.  A corpus document shorter than its drawn length
    bucket is tiled up to the bucket instead of silently truncated —
    every emitted prompt hits exactly its drawn bucket, so the bucketed
    prefill length distribution matches the requested mix.

    priorities: optional (classes, weights) mix, e.g.
    ``((PRIO_HIGH, PRIO_PREEMPTIBLE), (0.3, 0.7))``; default all
    PRIO_STANDARD.
    """
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    arrivals = np.cumsum(gaps)
    lens = rng.choice(np.asarray(prompt_lens), size=n)
    if corpus is not None:
        docs = corpus.sample_documents(n, seed=seed)
    else:
        docs = rng.integers(0, vocab_size, size=(n, int(max(prompt_lens))))
    if priorities is None:
        prios = np.full(n, PRIO_STANDARD)
    else:
        classes, weights = priorities
        prios = rng.choice(np.asarray(classes), size=n,
                           p=np.asarray(weights, np.float64)
                           / float(np.sum(weights)))
    out = []
    for i in range(n):
        doc = np.asarray(docs[i], np.int32).reshape(-1)
        want = int(lens[i])
        if len(doc) < want:   # tile short docs up to the drawn bucket
            doc = np.tile(doc, -(-want // len(doc)))
        out.append(Request(rid=i, prompt=doc[:want], max_new=max_new,
                           arrival=float(arrivals[i]),
                           priority=int(prios[i])))
    return out
