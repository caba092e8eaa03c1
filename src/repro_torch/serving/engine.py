"""Path-serving engines (paper §2.2/§2.6: "at test time, the paths are
instantiated and served independently, with text routed to each path via
a router").

The port of ``repro/serving/engine.py``.  Two engines share the routing
and feature machinery:

* :class:`PathServingEngine` — the one-shot batch engine: a synchronous
  ``generate`` over a fixed request batch, the prompt replayed through
  decode steps, full re-prefill on §2.4.3 re-route.
* :class:`ContinuousBatchingEngine` — tick-based continuous batching: an
  admission scheduler feeds per-path slot arenas; every tick prefills new
  admissions (one forward per prompt-length bucket) while decoding every
  in-flight request of all islands in one masked path-stacked decode
  step.  On a CUDA device that step can be captured once in a CUDA graph
  (``warmup``) and replayed every tick.

Under ``cfg.attn_impl == "pallas"`` the routing features go through the
flash-attention kernel and every decode step through flash-decode.

Both engines optionally serve from a deployment registry
(``repro_torch.deploy``): instead of a fixed ``path_params_list`` they
take a ``registry`` handle and hot-swap the whole path set *between
decode ticks* whenever the registry's tagged serving version moves
(promote or rollback).  Shapes and dtypes are unchanged by a swap, so
the continuous engine copies the new weights into its stacked weights in
place: the tensors that a captured CUDA-graph tick reads keep their
addresses, and the next replay serves the new version.  The per-request
policy is chosen at construction:

* ``swap_policy="drain"`` — in-flight requests finish on the version
  they were admitted under: admissions pause (scheduler backpressure)
  until the arenas drain, then the new version installs.  Requests
  admitted after the swap are token-identical to a freshly constructed
  engine on the new parameters.
* ``swap_policy="live"`` — the new version installs immediately and
  every in-flight request is migrated onto it mid-stream by
  re-prefilling its running text into its slot (the §2.4.3 migration
  primitive, minus the island move).  Token divergence is accepted and
  the affected requests are flagged ``swapped_midstream``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.routing.features import params_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (apply_lm, decode_step_paths, path_view,
                                   stack_paths)
from repro_torch.models.params import tree_map
from repro_torch.obs import as_telemetry

from .cache import PrefixCache, SlotArena, StackedSlotArenas
from .scheduler import (PRIO_HIGH, PRIO_PREEMPTIBLE, Request,
                        RequestState, Scheduler)


def _signature(params, key=()) -> list:
    """(key path, shape, dtype) of every leaf, in tree order."""
    if isinstance(params, dict):
        return [s for k, v in params.items()
                for s in _signature(v, key + (k,))]
    return [(key, tuple(params.shape), params.dtype)]


def _paths_homogeneous(path_params_list) -> bool:
    """True when every path shares one tree structure + leaf shapes and
    dtypes (same architecture), i.e. params can stack along a path
    axis."""
    s0 = _signature(path_params_list[0])
    return all(_signature(p) == s0 for p in path_params_list[1:])


def _default_buckets(cache_len: int):
    """Power-of-two prompt-length buckets, capped at cache_len."""
    buckets, b = [], 16
    while b < cache_len:
        buckets.append(b)
        b *= 2
    buckets.append(cache_len)
    return tuple(buckets)


@dataclass
class EngineOptions:
    """Construction options shared by both serving engines.

    The continuous-batching-only fields (``slots_per_path`` onward) are
    accepted and ignored by the one-shot engine, so one options object
    can configure either engine.  ``registry`` (a
    ``repro_torch.deploy.DeploymentRegistry``) replaces the engine's
    ``path_params_list``; ``swap_policy`` says how the continuous engine
    installs a new serving version.
    """

    router: Any = None
    route_fn: Any = None
    feat_params: Any = None
    registry: Any = None
    cache_len: int = 512
    swap_policy: str = "drain"
    # telemetry handle (repro_torch.obs.Telemetry) — None = no-op tracing
    telemetry: Any = None
    # --- ContinuousBatchingEngine only ---------------------------------
    slots_per_path: int = 8
    reroute_every: int = 0
    stacked: Optional[bool] = None
    bucketed_prefill: Optional[bool] = None
    prefill_buckets: Optional[tuple] = None
    # cross-request prefix cache capacity (entries); 0 = disabled
    prefix_cache: int = 0
    # allow a queued PRIO_HIGH admit to evict a PRIO_PREEMPTIBLE slot
    # (the evictee re-queues and re-admits via §2.4.3 re-prefill)
    preemption: bool = True
    # capture the dense stacked tick in a CUDA graph in ``warmup`` and
    # replay it every dense tick; None = on for stacked islands on a
    # CUDA device, False = the eager tick
    cuda_graph: Optional[bool] = None

    def __post_init__(self):
        if self.router is not None and self.route_fn is not None:
            raise ValueError("pass either router (feature-based) or "
                             "route_fn (prompt -> path id), not both")
        if self.swap_policy not in ("drain", "live"):
            raise ValueError(f"swap_policy must be 'drain' or 'live', "
                             f"got {self.swap_policy!r}")
        if self.cache_len < 1:
            raise ValueError(f"cache_len must be >= 1, "
                             f"got {self.cache_len}")
        if self.slots_per_path < 1:
            raise ValueError(f"slots_per_path must be >= 1, "
                             f"got {self.slots_per_path}")
        if self.reroute_every < 0:
            raise ValueError(f"reroute_every must be >= 0, "
                             f"got {self.reroute_every}")
        if self.prefill_buckets is not None:
            self.prefill_buckets = tuple(self.prefill_buckets)
            if any(b > self.cache_len or b < 1
                   for b in self.prefill_buckets):
                raise ValueError(
                    f"prefill_buckets {self.prefill_buckets} must lie "
                    f"in [1, cache_len={self.cache_len}]")
        if self.prefix_cache < 0:
            raise ValueError(f"prefix_cache must be >= 0, "
                             f"got {self.prefix_cache}")


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, prompt + new)
    paths: np.ndarray           # (B,) final path per request
    switches: int


@dataclass
class FinishedRequest:
    rid: int
    tokens: np.ndarray          # (prompt + new,)
    path: int                   # final path
    switches: int
    arrival: float
    admitted_at: float
    finished_at: float
    first_token_at: float = 0.0
    version: int = -1           # registry version the request finished on
    swapped_midstream: bool = False   # a live hot-swap hit this request
    priority: int = 1
    preemptions: int = 0        # times a high-priority admit evicted it

    @property
    def latency(self) -> float:
        return self.finished_at - self.arrival

    @property
    def ttft(self) -> float:
        """Time to first generated token, measured from the request's
        trace arrival (queue wait included); non-trace runs submit with
        ``arrival == 0.0`` and anchor at admission instead."""
        return self.first_token_at - (self.arrival or self.admitted_at)


@dataclass
class _Running(RequestState):
    """In-flight state.  ``next_token`` is the greedy id of the logits row
    that predicts ``tokens[len(tokens)]``, taken with ``torch.argmax`` on
    the logits' device (the first maximal index, as ``np.argmax``), so a
    decode tick copies back ids, not logits; ``next_logits`` stays
    None."""
    next_token: Optional[int] = None


def _greedy(logits: torch.Tensor) -> List[int]:
    """Greedy ids of logits rows (..., V), first maximum on ties."""
    return torch.argmax(logits, dim=-1).tolist()


class _EngineBase:
    """Shared routing / feature / registry plumbing."""

    def __init__(self, cfg: ModelConfig, path_params_list=None, *,
                 options: Optional[EngineOptions] = None):
        opts = options if options is not None else EngineOptions()
        if opts.registry is not None:
            if path_params_list is not None:
                raise ValueError(
                    "pass either path_params_list or registry, not both")
            self._version, path_params_list = opts.registry.serving()
        elif not path_params_list:
            raise ValueError("either path_params_list or a registry "
                             "handle is required")
        else:
            self._version = -1
        self.cfg = cfg
        self.options = opts
        self.registry = opts.registry
        self.swap_policy = opts.swap_policy
        self.tel = as_telemetry(opts.telemetry)
        self.paths = list(path_params_list)
        self.device = params_device(self.paths[0])
        self.router = opts.router
        self.route_fn = opts.route_fn
        self.feat_params = opts.feat_params
        self.cache_len = opts.cache_len
        # routing features come from ``feat_params``, else the first
        # path as constructed (the base LM): pinned, so that a hot swap
        # leaves routing as it was (the router is versioned with the
        # deployment, not with every weight swap)
        self._feat_src = (opts.feat_params if opts.feat_params is not None
                          else self.paths[0] if opts.router is not None
                          else None)

    @torch.inference_mode()
    def _feats(self, tokens) -> torch.Tensor:
        """Routing features of ``tokens`` (mean final hidden state)."""
        h, _ = apply_lm(self._feat_src, self.cfg, self._tokens(tokens),
                        return_hidden=True)
        return h.float().mean(dim=1)

    def route(self, tokens) -> np.ndarray:
        if self.route_fn is not None:
            return np.asarray([self.route_fn(t) for t in tokens], np.int32)
        if self.router is None:
            return np.zeros(tokens.shape[0], np.int32)
        z = self._feats(tokens[:, :self.cfg.route_prefix_len])
        return np.asarray(torch.as_tensor(self.router.assign(z)).cpu(),
                          np.int32)

    def _tokens(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.int32), device=self.device)

    @property
    def version(self) -> int:
        """Registry version currently installed (-1: no registry)."""
        return self._version


class PathServingEngine(_EngineBase):
    """One-shot batch engine: synchronous generate per batch."""

    def poll_registry(self) -> bool:
        """Install the registry's serving version if it moved.  Called
        between ``generate`` batches — drain semantics, since the
        one-shot engine holds no in-flight state across calls."""
        if self.registry is None:
            return False
        if self.registry.serving_version == self._version:
            return False
        t0 = time.monotonic_ns()
        self._version, paths = self.registry.serving()
        self.paths = list(paths)
        self.tel.complete_span("serve.swap", t0, policy="drain",
                               version=self._version)
        return True

    def _decode(self, params, tok, cache, idx):
        logits, cache = api.serve_step(params, self.cfg, {"tokens": tok},
                                       cache, idx)
        return logits[:, 0], cache

    def _build_cache(self, params, tokens):
        """Prefill by replaying tokens through decode steps."""
        b, s = tokens.shape
        cache = api.init_serve_cache(self.cfg, b, self.cache_len,
                                     device=self.device)
        logits = None
        for t in range(s):
            logits, cache = self._decode(params, tokens[:, t:t + 1], cache, t)
        return logits, cache

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int, *,
                 reroute_every: int = 0) -> GenerationResult:
        """Greedy generation.  With ``reroute_every`` a whole co-routed
        group follows the first request's re-route vote, as in the
        reference."""
        self.poll_registry()
        prompts = np.asarray(prompts)
        b, s0 = prompts.shape
        assign = self.route(prompts)
        switches = 0
        results = np.zeros((b, s0 + max_new), np.int32)
        results[:, :s0] = prompts
        final_paths = np.asarray(assign).copy()
        for p in np.unique(assign):
            sel = np.nonzero(assign == p)[0]
            params = self.paths[int(p)]
            # logits predicts the token at position `pos`
            logits, cache = self._build_cache(
                params, self._tokens(results[sel, :s0]))
            cur_path = int(p)
            pos = s0
            for t in range(max_new):
                nxt = torch.argmax(logits, dim=-1)     # greedy
                results[sel, pos] = nxt.cpu().numpy()
                if (reroute_every and (t + 1) % reroute_every == 0
                        and self.router is not None and t + 1 < max_new):
                    z = self._feats(
                        results[sel, max(0, pos - reroute_every + 1):pos + 1])
                    new_p = int(self.router.assign(z)[0])
                    if new_p != cur_path:
                        switches += 1
                        cur_path = new_p
                        params = self.paths[new_p]
                        # §6 limitation: rebuild the cache on the new path
                        logits, cache = self._build_cache(
                            params, self._tokens(results[sel, :pos + 1]))
                        pos += 1
                        continue
                logits, cache = self._decode(
                    params, self._tokens(results[sel, pos:pos + 1]), cache,
                    pos)
                pos += 1
            final_paths[sel] = cur_path
        return GenerationResult(tokens=results, paths=final_paths,
                                switches=switches)


@dataclass
class _TickGraph:
    """A captured dense stacked tick: ``inp`` (3, P, S) int32 holds the
    token ids, positions and mask that each replay reads; ``ids`` (P, S)
    the greedy ids it writes."""
    graph: Any
    inp: torch.Tensor
    ids: torch.Tensor


class ContinuousBatchingEngine(_EngineBase):
    """Continuous-batching, multi-path serving engine.

    Per tick: (1) route + admit arrivals into islands with free slots,
    prefilling admissions in length-bucketed batched forwards (prompts
    padded up to a small fixed bucket set, batches to a power of two);
    (2) decode every in-flight request of *all* islands in one
    path-stacked decode step (``decode_step_paths``: the weights stacked
    once, the attention of all P x S rows in one kernel launch a layer;
    rows that were prefilled this tick, or are free, keep their cache bit
    for bit); (3) emit one greedy token per request, retiring finished
    requests and migrating re-routed ones.

    When fewer than half the islands have work, the tick decodes only the
    active islands, one ``decode_step`` each on their rows of the stacked
    arena (the sparse tick).  On a CUDA device ``warmup`` captures the
    dense tick in a CUDA graph (``EngineOptions.cuda_graph``): a tick then
    copies one (3, P, S) int32 array in, replays the graph, and copies
    the (P, S) greedy ids out.

    ``stacked=False`` falls back to one decode step per island (required
    for heterogeneous path architectures, whose weights cannot stack);
    ``bucketed_prefill=False`` falls back to batch-1 exact-length prefill
    (automatic for SSM paths, whose recurrent state would absorb pad
    tokens).

    ``decode_stats`` counts the decode dispatches: ``dense`` ticks (eager
    or replayed), ``graph_replays`` among them, ``sparse_islands`` (one
    per island of a sparse tick) and ``looped_islands`` (stacked=False),
    and ``feature_calls`` (routing and re-route features).

    With a registry every tick first polls its serving version
    (``_poll_swap``); ``swaps`` counts the installs and
    ``last_swap_tick`` is the tick of the last one.
    """

    def __init__(self, cfg: ModelConfig, path_params_list=None, *,
                 options: Optional[EngineOptions] = None):
        super().__init__(cfg, path_params_list, options=options)
        opts = self.options
        cache_len = self.cache_len
        slots_per_path = opts.slots_per_path
        self.reroute_every = opts.reroute_every
        self.swaps = 0
        self.last_swap_tick = -1
        # monotonic start of a pending drain-policy swap window (the
        # serve.swap span runs from the first drain tick to the install)
        self._swap_wait_ns = None
        num_paths = len(self.paths)
        homog = _paths_homogeneous(self.paths)
        self.stacked = homog if opts.stacked is None else opts.stacked
        if self.stacked and not homog:
            raise ValueError("stacked decode requires homogeneous path "
                             "architectures; pass stacked=False")
        # pad tokens are causally invisible to attention rows, but a
        # recurrent SSM state (or enc-dec replay) would absorb them
        can_bucket = (not api.is_encdec(cfg)
                      and all(spec.mixer == "attn" for spec in cfg.pattern))
        self.bucketed = can_bucket if opts.bucketed_prefill is None \
            else opts.bucketed_prefill
        if self.bucketed and not can_bucket:
            raise ValueError("bucketed prefill requires attention-only "
                             "patterns; pass bucketed_prefill=False")
        buckets = (opts.prefill_buckets
                   if opts.prefill_buckets is not None
                   else _default_buckets(cache_len))
        # cache_len is always a bucket, so every admissible sequence
        # (submit caps prompt + max_new at it), migration re-prefills of
        # the running text included, has a bucket
        self.prefill_buckets = tuple(sorted(set(buckets) | {cache_len}))
        on_card = self.device.type == "cuda"
        if opts.cuda_graph and not (on_card and self.stacked):
            raise ValueError("cuda_graph=True needs stacked islands on a "
                             "CUDA device")
        self.cuda_graph = (on_card and self.stacked
                           if opts.cuda_graph is None else opts.cuda_graph)
        self._graph: Optional[_TickGraph] = None
        with torch.no_grad():
            if self.stacked:
                # stacked once; each path's weights become views into the
                # stack, so they are not held twice
                self._stacked_params = stack_paths(self.paths)
                self.paths = [path_view(self._stacked_params, p)
                              for p in range(num_paths)]
                self._stacked_arenas = StackedSlotArenas(
                    cfg, num_paths, slots_per_path, cache_len,
                    device=self.device)
                self.arenas = self._stacked_arenas.arenas
            else:
                self._stacked_params = None
                self._stacked_arenas = None
                self.arenas = [SlotArena(cfg, slots_per_path, cache_len,
                                         device=self.device)
                               for _ in self.paths]
        self.scheduler = Scheduler(num_paths)
        self.in_flight: Dict[int, _Running] = {}
        self.ticks = 0
        self.preemption = opts.preemption
        # rid -> state evicted by a high-priority admit; restored (new
        # slot + §2.4.3 re-prefill of the running text) on re-admission
        self._preempted: Dict[int, _Running] = {}
        self.prefix_cache = (PrefixCache(opts.prefix_cache)
                             if opts.prefix_cache else None)
        # states whose first token was emitted this tick — realtime
        # serve_trace re-stamps their first_token_at after the step
        self._new_first: list = []
        self.decode_stats = dict.fromkeys(
            ("dense", "graph_replays", "sparse_islands", "looped_islands",
             "feature_calls"), 0)

    # -- model calls ---------------------------------------------------
    def _feats(self, tokens) -> torch.Tensor:
        self.decode_stats["feature_calls"] += 1
        return super()._feats(tokens)

    def _prefill(self, params, tokens):
        """Exact-length prefill -> (last logits rows (B, V), cache)."""
        logits, cache = api.prefill(params, self.cfg,
                                    {"tokens": self._tokens(tokens)},
                                    self.cache_len)
        return logits[:, -1], cache

    def _prefill_bucketed(self, params, tokens, last):
        """Padded-bucket prefill: per-row gather of the logits at each
        prompt's true last token (pad rows and tails ignored)."""
        logits, cache = api.prefill(params, self.cfg,
                                    {"tokens": self._tokens(tokens)},
                                    self.cache_len)
        rows = torch.arange(logits.shape[0], device=logits.device)
        return logits[rows, torch.as_tensor(last, device=logits.device)], \
            cache

    def _extend(self, params, token: int, row, index: int):
        """Prefix-cache extension: replay one token into a single-slot
        row in place -> the logits row (V,)."""
        logits, _ = api.serve_step(params, self.cfg,
                                   {"tokens": self._tokens([[token]])},
                                   row, index)
        return logits[0, 0]

    def _decode_masked(self, params, tok, cache, idx, mask) -> np.ndarray:
        """One masked decode step of one island's rows -> greedy ids."""
        logits, _ = api.serve_step(
            params, self.cfg, {"tokens": self._tokens(tok)}, cache,
            self._tokens(idx),
            mask=torch.as_tensor(mask, device=self.device))
        return np.asarray(_greedy(logits[:, 0]))

    def _dense_body(self, inp: torch.Tensor) -> torch.Tensor:
        """The dense stacked tick on ``inp`` (3, P, S) int32 (ids,
        positions, mask) -> greedy ids (P, S), all on the device: no host
        sync, so it can be captured."""
        logits, _ = decode_step_paths(
            self._stacked_params, self.cfg, inp[0, :, :, None],
            self._stacked_arenas.cache, inp[1], inp[2] != 0)
        return torch.argmax(logits[:, :, 0], dim=-1)

    def _decode_stacked(self, packed: np.ndarray) -> np.ndarray:
        """The dense stacked tick on the host array ``packed`` (3, P, S)
        -> greedy ids (P, S): replayed from the captured graph where there
        is one, else run eagerly."""
        g = self._graph
        if g is None:
            ids = self._dense_body(torch.from_numpy(packed).to(self.device))
        else:
            g.inp.copy_(torch.from_numpy(packed))
            g.graph.replay()
            self.decode_stats["graph_replays"] += 1
            ids = g.ids
        return ids.cpu().numpy()

    def _decode_island(self, p: int, packed: np.ndarray) -> np.ndarray:
        """Island ``p``'s rows of the stacked arena, decoded in place by
        one masked step -> its greedy ids (S,)."""
        return self._decode_masked(self.paths[p], packed[0, p, :, None],
                                   self.arenas[p].cache,
                                   packed[1, p], packed[2, p] != 0)

    def _capture_tick(self) -> None:
        """Capture the dense tick once.  The warm-up call and the capture
        run with the mask all False, which leaves every cache row as it
        was; a capture that fails raises."""
        sa = self._stacked_arenas
        dev = self.device
        inp = torch.zeros((3, sa.num_paths, sa.num_slots), dtype=torch.int32,
                          device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._dense_body(inp)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ids = self._dense_body(inp)
        self._graph = _TickGraph(graph, inp, ids)

    # -- hot swap (deployment registry) --------------------------------
    @torch.no_grad()
    def _install(self, version: int, paths) -> None:
        """Swap the serving weights between ticks.  Stacked islands copy
        each new path's leaves into the stacked weights in place (never a
        rebind: a captured tick reads those tensors, and a rebind would
        leave its replays serving the old version); ``self.paths`` are
        views into the stack, so they follow."""
        if self.stacked:
            for p, new in enumerate(paths):
                tree_map(lambda dst, src: dst.copy_(src),
                         path_view(self._stacked_params, p), new)
        else:
            self.paths = list(paths)
        self._version = version
        self.swaps += 1
        self.last_swap_tick = self.ticks
        if self.prefix_cache is not None:
            self.prefix_cache.invalidate()

    def _poll_swap(self) -> bool:
        """Install a new serving version if the registry moved; returns
        True while a drain-policy swap is pending (admissions pause)."""
        if self.registry is None:
            return False
        if self.registry.serving_version == self._version:
            return False
        version, paths = self.registry.serving()
        if version == self._version:
            return False
        if self.swap_policy == "live":
            t0 = time.monotonic_ns()
            self._install(version, paths)
            self._reprefill_inflight()
            self.tel.complete_span("serve.swap", t0, policy="live",
                                   version=version, tick=self.ticks)
            return False
        if self.in_flight:
            # drain: in-flight requests finish on their admitted
            # version; new admissions wait (scheduler backpressure)
            if self._swap_wait_ns is None:
                self._swap_wait_ns = time.monotonic_ns()
            return True
        t0 = self._swap_wait_ns or time.monotonic_ns()
        self._swap_wait_ns = None
        self._install(version, paths)
        self.tel.complete_span("serve.swap", t0, policy="drain",
                               version=version, tick=self.ticks)
        return False

    def _reprefill_inflight(self) -> None:
        """Live-swap migration: rebuild every in-flight request's cache
        row on the just-installed version by re-prefilling its running
        text into its own slot (in place in the stacked arena; the tick
        that follows leaves the row alone, as it does every row
        prefilled this tick).  The continuation diverges from both the
        old-version stream and a fresh new-version generation —
        accepted, and the request is flagged."""
        for st in self.in_flight.values():
            logits, cache = self._prefill_running(st.path, st.tokens)
            self.arenas[st.path].write_slots(cache, [st.slot],
                                             [len(st.tokens)])
            st.next_token = _greedy(logits)
            st.prefilled_this_tick = True
            st.swapped_midstream = True
            st.version = self._version

    def device_state(self):
        """Device buffers the next tick reads (to synchronize on before
        reading a clock)."""
        if self.stacked:
            return [leaf for c in self._stacked_arenas.cache.values()
                    for leaf in c.values()]
        return [leaf for a in self.arenas for c in a.cache.values()
                for leaf in c.values()]

    def _bucket(self, n: int) -> int:
        """Smallest configured bucket >= n (always exists: the bucket set
        contains cache_len and submit caps sequences at it)."""
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise AssertionError(
            f"length {n} exceeds every bucket {self.prefill_buckets}")

    @torch.no_grad()
    def warmup(self) -> None:
        """Run every (length-bucket, batch-bucket) prefill variant and the
        decode dispatches once off the serving clock (cuBLAS handles, the
        kernels' first launches and builds), then, where
        ``self.cuda_graph``, capture the dense tick.  Every decode here
        runs with the mask all False: no cache row changes."""
        slots = self.arenas[0].num_slots
        sizes, r = [], 1
        while r < slots:
            sizes.append(r)
            r <<= 1
        sizes.append(r)
        seen = set()
        warm_paths = []
        for p in self.paths:
            sig = tuple(_signature(p))
            if sig not in seen:
                seen.add(sig)
                warm_paths.append(p)
        if self.bucketed:
            for params in warm_paths:
                for length in self.prefill_buckets:
                    for rows in sizes:
                        self._prefill_bucketed(
                            params, np.zeros((rows, length), np.int32),
                            np.full(rows, length - 1, np.int64))
        zeros = np.zeros(slots, np.int32)
        if self.stacked:
            sa = self._stacked_arenas
            idle = np.zeros((3, sa.num_paths, slots), np.int32)
            self._decode_stacked(idle)
            self._decode_island(0, idle)
            if self.cuda_graph:
                self._capture_tick()
        else:
            for p, params in enumerate(self.paths):
                self._decode_masked(params, zeros[:, None],
                                    self.arenas[p].cache, zeros,
                                    np.zeros(slots, bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- submission ----------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds cache_len {self.cache_len}")
        if len(req.prompt) < self.cfg.route_prefix_len and self.router:
            raise ValueError(
                f"request {req.rid}: prompt shorter than routing prefix "
                f"({self.cfg.route_prefix_len})")
        self.scheduler.submit(req)

    def _route_prompt(self, prompt: np.ndarray) -> int:
        if self.route_fn is not None:
            return int(self.route_fn(prompt))
        if self.router is None:
            return 0
        z = self._feats(prompt[None, :self.cfg.route_prefix_len])
        return int(self.router.assign(z)[0])

    # -- one engine tick ----------------------------------------------
    @torch.no_grad()
    def step(self, now: float = 0.0) -> List[FinishedRequest]:
        """Advance the engine one tick; returns requests finished now."""
        if self.cuda_graph and self._graph is None:
            raise RuntimeError("the dense tick is set to replay a CUDA "
                               "graph: call warmup() first to capture it")
        self.ticks += 1
        with self.tel.span("serve.tick", tick=self.ticks) as sp:
            draining = self._poll_swap()
            self.scheduler.route_arrivals(self._route_prompt)
            if not draining:
                if self.preemption:
                    self._preempt_tick()
                admissions = self.scheduler.admissions(
                    {p: a.num_free for p, a in enumerate(self.arenas)})
                for p, reqs in admissions.items():
                    self._admit(p, reqs, now)
            elif self.scheduler.pending:
                # the drain pause is backpressure too: every queued
                # request waits on the swap, not on slots
                self.scheduler.drain_backpressure()
            self._decode_tick()
            fins = self._emit_tick(now)
            sp.set(in_flight=len(self.in_flight), finished=len(fins))
        return fins

    def _preempt_tick(self) -> None:
        """Evict PRIO_PREEMPTIBLE slots for queued PRIO_HIGH admits.

        Per island: when more high-priority requests wait than slots are
        free, the least-progressed preemptible occupants release their
        slots.  An evictee re-queues at the head of its class and
        re-admits through the §2.4.3 re-prefill path, so its greedy
        continuation equals an uninterrupted run's.
        """
        for p, arena in enumerate(self.arenas):
            need = self.scheduler.queued(p, PRIO_HIGH) - arena.num_free
            if need <= 0:
                continue
            victims = sorted(
                (st for st in self.in_flight.values()
                 if st.path == p
                 and st.req.priority == PRIO_PREEMPTIBLE),
                key=lambda st: st.emitted)
            for st in victims[:need]:
                arena.free(st.slot)
                del self.in_flight[st.req.rid]
                st.preemptions += 1
                st.next_token = None
                st.prefilled_this_tick = False
                self._preempted[st.req.rid] = st
                self.scheduler.requeue(st.req, p)
                self.scheduler.stats.preemptions += 1
                self.tel.instant("serve.preempt", path=p, rid=st.req.rid,
                                 emitted=st.emitted)

    def _prefill_running(self, path: int, tokens):
        """Re-prefill a request's running text on island ``path`` (the
        §2.4.3 migration primitive): -> (next-token logits row, cache)."""
        n = len(tokens)
        if self.bucketed:
            tok = np.zeros((1, self._bucket(n)), np.int32)
            tok[0, :n] = tokens
            logits, cache = self._prefill_bucketed(self.paths[path], tok,
                                                   [n - 1])
        else:
            logits, cache = self._prefill(self.paths[path],
                                          np.asarray(tokens)[None])
        return logits[0], cache

    def _prefix_admit(self, path: int, r: Request, arena,
                      now: float) -> bool:
        """Admit ``r`` from the cross-request prefix cache when (a prefix
        of) its prompt is cached under the current version.

        Exact hits write the stored row and take the stored logits;
        prefix hits replay only the uncached tail through single-row
        decode steps into a copy of the stored row, and store the
        extended row as a full-prompt entry.
        """
        if self.prefix_cache is None:
            return False
        hit = self.prefix_cache.lookup(path, self._version, r.prompt)
        if hit is None:
            return False
        n, row, logits = hit
        s0 = len(r.prompt)
        if n < s0:
            # the replay writes in place: never into the stored entry
            row = tree_map(torch.clone, row)
            for t in range(n, s0):
                logits = self._extend(self.paths[path], int(r.prompt[t]),
                                      row, t)
            self.prefix_cache.put(path, self._version, r.prompt, row, logits)
        slot = arena.alloc()
        arena.write_slots(row, [slot], [s0])
        self.in_flight[r.rid] = _Running(
            req=r, path=path, slot=slot, tokens=list(map(int, r.prompt)),
            next_token=_greedy(logits), prefilled_this_tick=True,
            admitted_at=now, version=self._version)
        return True

    def _admit(self, path: int, reqs: List[Request], now: float) -> None:
        """Prefill admissions.

        Bucketed mode (default for attention paths): prompts are
        right-padded up to a small fixed set of bucket lengths and the
        batch is padded to a power of two, so each bucket's admission
        group prefills in ONE forward.  Pad tokens are harmless: each
        junk cache slot is overwritten by decode before the ring-validity
        mask would admit it, and the per-row logits gather reads each
        prompt's true last position.

        Fallback: batch-1 exact-length prefill per request.
        """
        self.tel.instant("serve.admit", path=path, n=len(reqs))
        arena = self.arenas[path]
        fresh: List[Request] = []
        for r in reqs:
            st = self._preempted.pop(r.rid, None)
            if st is not None:
                # preemption re-admission: restore the running text
                # through the §2.4.3 re-prefill primitive
                slot = arena.alloc()
                logits, cache = self._prefill_running(path, st.tokens)
                arena.write_slots(cache, [slot], [len(st.tokens)])
                st.path, st.slot = path, slot
                st.next_token = _greedy(logits)
                st.prefilled_this_tick = True
                self.in_flight[r.rid] = st
            elif not self._prefix_admit(path, r, arena, now):
                fresh.append(r)
        reqs = fresh
        if not reqs:
            return
        if not self.bucketed:
            for r in reqs:
                logits, cache = self._prefill(self.paths[path],
                                              r.prompt[None])
                slot = arena.alloc()
                arena.write_slots(cache, [slot], [len(r.prompt)])
                self.in_flight[r.rid] = _Running(
                    req=r, path=path, slot=slot,
                    tokens=list(map(int, r.prompt)),
                    next_token=_greedy(logits[0]), prefilled_this_tick=True,
                    admitted_at=now, version=self._version)
                if self.prefix_cache is not None:
                    self.prefix_cache.put(path, self._version, r.prompt,
                                          cache, logits[0])
            return
        groups: Dict[int, List[Request]] = {}
        for r in reqs:
            groups.setdefault(self._bucket(len(r.prompt)), []).append(r)
        for length, group in sorted(groups.items()):
            rows = 1 << (len(group) - 1).bit_length()   # batch bucket
            tok = np.zeros((rows, length), np.int32)
            last = np.zeros(rows, np.int64)
            for i, r in enumerate(group):
                tok[i, :len(r.prompt)] = r.prompt
                last[i] = len(r.prompt) - 1
            logits, cache = self._prefill_bucketed(self.paths[path], tok,
                                                   last)
            slots = [arena.alloc() for _ in group]
            arena.write_slots(cache, slots, [len(r.prompt) for r in group])
            ids = _greedy(logits)
            for i, r in enumerate(group):
                self.in_flight[r.rid] = _Running(
                    req=r, path=path, slot=slots[i],
                    tokens=list(map(int, r.prompt)), next_token=ids[i],
                    prefilled_this_tick=True, admitted_at=now,
                    version=self._version)
                if self.prefix_cache is not None:
                    self.prefix_cache.put(
                        path, self._version, r.prompt,
                        tree_map(lambda x, i=i: x[:, i:i + 1], cache),
                        logits[i])

    def _decode_tick(self) -> None:
        """Advance every in-flight request one token.

        Stacked mode: one path-stacked step decodes the full (paths,
        slots) arena.  Fallback: one masked decode step per island with
        work.
        """
        if self.stacked:
            self._decode_tick_stacked()
            return
        for p, arena in enumerate(self.arenas):
            rows = [st for st in self.in_flight.values()
                    if st.path == p and not st.prefilled_this_tick]
            if not rows:
                continue
            tok = np.zeros((arena.num_slots, 1), np.int32)
            mask = np.zeros(arena.num_slots, bool)
            for st in rows:
                arena.positions[st.slot] = len(st.tokens) - 1
                tok[st.slot, 0] = st.tokens[-1]
                mask[st.slot] = True
            ids = self._decode_masked(self.paths[p], tok, arena.cache,
                                   arena.decode_indices(), mask)
            self.decode_stats["looped_islands"] += 1
            for st in rows:
                st.next_token = int(ids[st.slot])

    def _decode_tick_stacked(self) -> None:
        sa = self._stacked_arenas
        rows = [st for st in self.in_flight.values()
                if not st.prefilled_this_tick]
        if not rows:
            return
        # (ids, positions, mask) as one int32 array: one copy to the card
        packed = np.zeros((3, sa.num_paths, sa.num_slots), np.int32)
        for st in rows:
            sa.positions[st.path, st.slot] = len(st.tokens) - 1
            packed[0, st.path, st.slot] = st.tokens[-1]
            packed[2, st.path, st.slot] = 1
        packed[1] = sa.positions
        active = sorted({st.path for st in rows})
        if 2 * len(active) >= sa.num_paths:
            # dense tick: one step (or one graph replay) advances every
            # island
            ids = self._decode_stacked(packed)
            self.decode_stats["dense"] += 1
            for st in rows:
                st.next_token = int(ids[st.path, st.slot])
            return
        # sparse tick (e.g. trace drain): decode only the active islands,
        # each on its rows of the stacked arena, in place
        out = {}
        for p in active:
            out[p] = self._decode_island(p, packed)
            self.decode_stats["sparse_islands"] += 1
        for st in rows:
            st.next_token = int(out[st.path][st.slot])

    def _emit_tick(self, now: float) -> List[FinishedRequest]:
        """Append one greedy token per request; retire / migrate."""
        done: List[FinishedRequest] = []
        self._new_first = []
        for st in list(self.in_flight.values()):
            st.prefilled_this_tick = False
            st.tokens.append(int(st.next_token))
            if st.first_token_at is None:
                st.first_token_at = now
                self._new_first.append(st)
            if st.done:
                self.arenas[st.path].free(st.slot)
                fin = FinishedRequest(
                    rid=st.req.rid, tokens=np.asarray(st.tokens, np.int32),
                    path=st.path, switches=st.switches,
                    arrival=st.req.arrival, admitted_at=st.admitted_at,
                    finished_at=now, first_token_at=st.first_token_at,
                    version=st.version,
                    swapped_midstream=st.swapped_midstream,
                    priority=st.req.priority,
                    preemptions=st.preemptions)
                done.append(fin)
                del self.in_flight[st.req.rid]
                self.scheduler.record_completion()
                continue
            if (self.reroute_every and self.router is not None
                    and st.emitted % self.reroute_every == 0):
                self._maybe_migrate(st)
        return done

    def _maybe_migrate(self, st: _Running) -> None:
        """§2.4.3 re-route: incremental cache migration to a new path.

        Re-prefills the running text only into a freshly allocated slot
        on the target island and evicts the source slot; deferred when
        the target island has no free slot.
        """
        window = self.reroute_every
        z = self._feats(np.asarray(st.tokens[-window:], np.int32)[None])
        new_p = int(self.router.assign(z)[0])
        if new_p == st.path:
            return
        slot = self.arenas[new_p].try_alloc()
        if slot is None:
            return
        logits, cache = self._prefill_running(new_p, st.tokens)
        self.arenas[new_p].write_slots(cache, [slot], [len(st.tokens)])
        self.arenas[st.path].free(st.slot)
        st.path, st.slot = new_p, slot
        st.next_token = _greedy(logits)
        st.switches += 1
        st.prefilled_this_tick = True

    # -- drivers -------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not self.in_flight and self.scheduler.pending == 0

    def serve_trace(self, trace: List[Request], *, realtime: bool = False,
                    tick_dt: float = 1e-3) -> List[FinishedRequest]:
        """Drive a full arrival trace to completion.

        realtime=False replays arrivals on a simulated clock advancing
        ``tick_dt`` seconds per engine tick (deterministic, for tests);
        realtime=True paces arrivals on the wall clock for throughput
        measurement.  A tick ends with its greedy ids on the host, so the
        post-step clock includes the tick's device work.
        """
        trace = sorted(trace, key=lambda r: r.arrival)
        i = 0
        now = 0.0
        t0 = time.perf_counter()
        out: List[FinishedRequest] = []
        while i < len(trace) or not self.idle:
            if realtime:
                now = time.perf_counter() - t0
            elif self.idle and i < len(trace):
                now = max(now, trace[i].arrival)   # jump over idle gaps
            while i < len(trace) and trace[i].arrival <= now:
                self.submit(trace[i])
                i += 1
            if self.idle and i < len(trace) and realtime:
                time.sleep(min(1e-3, trace[i].arrival - now))
                continue
            fins = self.step(now=now)
            if realtime:
                # re-stamp completions AND first tokens at the post-step
                # clock: the tick's device compute belongs in TTFT
                now = time.perf_counter() - t0
                new_rids = {st.req.rid for st in self._new_first}
                for st in self._new_first:
                    st.first_token_at = now
                for f in fins:
                    f.finished_at = now
                    if f.rid in new_rids:
                        f.first_token_at = now
            else:
                now += tick_dt
            out.extend(fins)
        self.tel.flush()   # trace safe point: trace ends with the run
        return out
