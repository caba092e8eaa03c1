"""Serving cells: ``repro_torch.serving.ContinuousBatchingEngine`` over
the seed's paths, routed by k-means over prefix features (paper §2.2,
§2.4.1: each request runs on the one path its router picks).

Set-up: the seed's path weights; the router's centroids from k-means
(``kmeans_fit``) over the prefix features (``prefix_features``, path 0
as the base model) of ``router_docs`` documents; the engine with its
prompt-length buckets set to the mix's prompt lengths, and its
``warmup()`` (every bucket's prefills, the decode step, the CUDA-graph
capture of the dense tick).

The window is the benchmark's own open loop around ``engine.step``: it
submits each request when it is due (``arrival_times``), with set-up's
objects frozen out of the collector's reach (``hostload.Window``).
Every time is read on the host clock after the step that produced it:
a first token at the end of the step that emitted it, a finish
likewise.  After
``--seconds`` no request is sent; the engine drains for at most
``drain_s``, and a request not finished by then has failed.  With ``--trace 1`` the window also keeps the
program's telemetry (``serve.tick`` spans), and the profiler's slice
follows the drain (``trace_slice``).
"""
from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from bench import devtrace, generator, hostload, weights
from bench.devtrace import Slice, device_sync, span
from bench.drivers.train import program_config
from bench.harness import Run
from bench.tools import faults as fault_lib

SLICE_WARM_S = 10.0     # seconds of the slice's traffic before it is traced


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` (linear interpolation
    between the two nearest ranks, as numpy's default); a missing value
    (inf) counts above every other, and a percentile that reaches one is
    infinite."""
    x = np.sort(np.asarray(values, np.float64))
    pos = (len(x) - 1) * q / 100.0
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if not np.isfinite(x[hi]):
        return math.inf
    return float(x[lo] + (x[hi] - x[lo]) * (pos - lo))


class Stamps:
    """Per-request host times and token counts, read from the engine's
    state after each step."""

    def __init__(self):
        self.due, self.first, self.done, self.new = {}, {}, {}, {}
        self.prompt = {}
        self.emitted = 0          # generated tokens, all steps so far
        self.live = []            # requests in flight after each step
        self.live_path_max = {}   # path -> most in flight after a step

    def submit(self, rid: int, due: float, prompt_len: int) -> None:
        self.due[rid], self.prompt[rid], self.new[rid] = due, prompt_len, 0

    def after_step(self, eng, fins, now: float) -> list:
        """Record the step that ended at ``now``; -> rids finished."""
        seen = [(st.req.rid, len(st.tokens)) for st in eng.in_flight.values()]
        seen += [(f.rid, len(f.tokens)) for f in fins]
        for rid, n in seen:
            gen = n - self.prompt[rid]
            if gen > self.new[rid]:
                self.emitted += gen - self.new[rid]
                self.new[rid] = gen
                self.first.setdefault(rid, now)
        for f in fins:
            self.done[f.rid] = now
        self.live.append(len(eng.in_flight))
        per_path = Counter(st.path for st in eng.in_flight.values())
        for p, n in per_path.items():
            self.live_path_max[p] = max(n, self.live_path_max.get(p, 0))
        return [f.rid for f in fins]


def serve_window(eng, reqs, seconds: float, stamps: Stamps, Request,
                 rid0: int = 0, tracer=None) -> dict:
    """Drive the engine for ``seconds``, each request submitted when it
    is due. -> {"window_s", "emitted" (generated tokens of the window),
    "new", "finished": every FinishedRequest, "clock", "stamps"}."""
    t0 = time.perf_counter()
    clock = lambda: time.perf_counter() - t0   # noqa: E731
    finished = []

    def send(k: int) -> None:
        r = reqs[k]
        eng.submit(Request(rid=rid0 + k, prompt=r["prompt"],
                           max_new=r["max_new"], arrival=r["due"]))
        stamps.submit(rid0 + k, r["due"], len(r["prompt"]))

    i = 0
    while True:
        now = clock()
        if now >= seconds:
            break
        if tracer is not None and now >= seconds - devtrace.SLICE_S:
            tracer.begin()
        while i < len(reqs) and reqs[i]["due"] <= now:
            send(i)
            i += 1
        if eng.idle:
            wake = reqs[i]["due"] if i < len(reqs) else seconds
            with span("bench.serve.wait"):
                time.sleep(max(0.0, min(wake, seconds) - now))
            continue
        with span("bench.serve.step"):
            fins = eng.step(now=now)
        finished += fins
        stamps.after_step(eng, fins, clock())
    # requests that fell due during the window's last step
    for k in range(i, len(reqs)):
        if reqs[k]["due"] < seconds:
            send(k)
    return {"window_s": clock(), "emitted": stamps.emitted,
            "new": dict(stamps.new), "finished": finished, "clock": clock,
            "stamps": stamps, "live": list(stamps.live)}


def drain(eng, w: dict, stamps: Stamps, limit_s: float) -> None:
    """Step the engine until it is idle or ``limit_s`` after the window;
    what it finishes joins ``w["finished"]``."""
    clock = w["clock"]
    deadline = clock() + limit_s
    while not eng.idle and clock() < deadline:
        fins = eng.step(now=clock())
        w["finished"] += fins
        stamps.after_step(eng, fins, clock())


def window_work(stamps: Stamps, w: dict) -> dict:
    """Tokens the model processed in the window (the prompts of the
    requests whose prefill ended in it, one token a later decode step)
    and the keys those tokens attended."""
    tokens = context = 0
    for rid, g in w["new"].items():
        if g == 0:
            continue
        p = stamps.prompt[rid]
        if stamps.first[rid] <= w["window_s"]:
            tokens += p
            context += p * (p + 1) // 2
        tokens += g - 1
        context += (g - 1) * p + g * (g - 1) // 2
    return {"tokens": tokens, "context": context}


def build_engine(spec, seed: int, device: str, tel=None, faults=()):
    """The seed's paths, the k-means router over their prefix features,
    and the engine, warmed up -> (engine, centroids, unplant)."""
    from repro_torch.core.routing.features import prefix_features
    from repro_torch.core.routing.kmeans import KMeansRouter, kmeans_fit
    from repro_torch.kernels import build
    from repro_torch.models.params import param_shapes
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineOptions)

    m, mix = spec.model, spec.mix
    cfg = program_config(m)
    weights.check_layout(m, param_shapes(cfg))
    if device == "cuda":
        build.build()
    paths = weights.make_paths(m, seed, mix["paths"], device)
    docs, domains = generator.corpus_documents(
        mix, m["vocab_size"], mix["router_docs"], seed, stream=3,
        with_domains=True)
    feats = prefix_features(paths[0], cfg, docs[:, :m["route_prefix_len"]])
    # Lloyd's iterations from one document of each domain: every seed's
    # router splits the traffic the same way, so runs do the same work
    first = [int(np.nonzero(domains == d)[0][0])
             for d in range(mix["num_domains"])]
    centroids, _, _ = kmeans_fit(feats, mix["paths"],
                                 iters=mix["kmeans_iters"],
                                 init=feats[first])
    eng = ContinuousBatchingEngine(cfg, paths, options=EngineOptions(
        cache_len=mix["cache_len"], slots_per_path=mix["slots"],
        cuda_graph=device == "cuda", router=KMeansRouter(centroids),
        feat_params=paths[0], prefill_buckets=tuple(mix["prompt_lens"]),
        telemetry=tel))
    unplant = fault_lib.plant_engine(faults, eng)
    eng.warmup()
    return eng, centroids, unplant


def make_requests(spec, seed: int, seconds: float, stream: int = 2) -> list:
    """The window's requests, each with its due time."""
    mix = spec.mix
    due = generator.arrival_times(mix, seconds)
    pool = generator.requests(mix, spec.model["vocab_size"], len(due), seed,
                              stream=stream)
    return [{"prompt": p, "max_new": k, "due": float(due[i])}
            for i, (p, k) in enumerate(pool)]


def tails(stamps: Stamps) -> dict:
    """Over every request sent in the window: attempted, failed (not
    finished after the drain), and the 95th percentiles of TTFT and TPOT
    in ms (a failed request's are infinite)."""
    rids = sorted(stamps.due)
    inf = math.inf
    ttft = [stamps.first.get(r, inf) - stamps.due[r] for r in rids]
    tpot = [(stamps.done[r] - stamps.first[r]) / (stamps.new[r] - 1)
            if r in stamps.done and stamps.new[r] > 1 else inf for r in rids]
    return {"attempted": len(rids),
            "failed": sum(r not in stamps.done for r in rids),
            "ttft_p95_ms": percentile(ttft, 95) * 1e3,
            "tpot_p95_ms": percentile(tpot, 95) * 1e3}


def trace_slice(out, eng, spec, seed: int, rid0: int, Request) -> None:
    """The profiler's slice, after the window and its drain: the mix's
    traffic afresh (requests of another stream of the seed) for
    ``SLICE_WARM_S``, untraced, to reach its steady load, then
    ``SLICE_S`` traced; then a drain.  Sets ``out.trace`` and
    ``out.trace_window_s``."""
    length = SLICE_WARM_S + devtrace.SLICE_S
    reqs = make_requests(spec, seed, length, stream=4)
    tracer = Slice()
    w = serve_window(eng, reqs, length, Stamps(), Request,
                     rid0=10 ** 7 + rid0, tracer=tracer)
    tracer.end()
    drain(eng, w, w["stamps"], spec.mix["drain_s"])
    out.trace = tracer.read()
    out.trace_window_s = tracer.window_s


def run(spec, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, faults=()) -> Run:
    from repro_torch.obs import Telemetry, read_trace
    from repro_torch.serving.scheduler import Request

    m, mix = spec.model, spec.mix
    tel_dir = tel = None
    if trace:
        tel_dir = tempfile.mkdtemp(prefix="bench-telemetry-")
        tel = Telemetry(os.path.join(tel_dir, "serve.jsonl"), fresh=True)
    eng, centroids, unplant = build_engine(spec, seed, device, tel, faults)
    reqs = make_requests(spec, seed, seconds)
    device_sync()
    out = Run(spec)
    out.e2e["setup_s"] = time.perf_counter() - t_start

    stamps = Stamps()
    mono0 = time.monotonic_ns()
    with hostload.Window() as host:
        w = serve_window(eng, reqs, seconds, stamps, Request)
    mono1 = time.monotonic_ns()
    out.window_s = w["window_s"]
    drain(eng, w, stamps, mix["drain_s"])
    t = tails(stamps)
    out.attempted, out.failed = t["attempted"], t["failed"]
    out.e2e["serve_tokens_per_s"] = w["emitted"] / out.window_s
    out.e2e.update(ttft_p95_ms=t["ttft_p95_ms"], tpot_p95_ms=t["tpot_p95_ms"])
    out.host["live"] = w["live"]
    out.notes.append(host.line(
        ttft_p95_ms=t["ttft_p95_ms"], tpot_p95_ms=t["tpot_p95_ms"],
        live_mean=float(np.mean(w["live"])) if w["live"] else 0.0,
        live_max=max(w["live"], default=0),
        live_path_max=[stamps.live_path_max.get(p, 0)
                       for p in range(mix["paths"])]))
    fins = w["finished"]
    out.work.update(emitted=w["emitted"], **window_work(stamps, w),
                    path_counts=np.bincount([f.path for f in fins],
                                            minlength=mix["paths"]).tolist())
    if trace:
        trace_slice(out, eng, spec, seed, len(reqs), Request)
    if tel is not None:
        tel.close()
        recs = read_trace(os.path.join(tel_dir, "serve.jsonl"))[0]
        out.host["tick_s"] = [(r["t1"] - r["t0"]) / 1e9 for r in recs
                              if r.get("name") == "serve.tick"
                              and mono0 <= r["t0"] and r["t1"] <= mono1]
        shutil.rmtree(tel_dir, ignore_errors=True)
    out.host["queue_wait_s"] = [f.admitted_at - f.arrival for f in fins]
    if device == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    served = sample(fins, stamps, seed, mix["check_tokens"])
    cents = centroids.detach().cpu()
    unplant()
    del eng, centroids
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    from bench.reference import checks
    out.numbers = checks.served_gaps(
        m, seed, mix["paths"], served, cents, device,
        precision="fp8" if "control" in faults else "f32")
    return out


def sample(fins, stamps: Stamps, seed: int, tokens: int) -> list:
    """The finished requests the reference judges: the longest, then
    others in an order drawn from the seed, until ``tokens`` served
    tokens -> [(prompt, generated tokens, path)]."""
    rng = np.random.default_rng([seed, 7])
    by_len = sorted(fins, key=lambda f: (-len(f.tokens), f.rid))
    order = [by_len[0]] + [by_len[i] for i in
                           rng.permutation(len(by_len) - 1) + 1]
    served, total = [], 0
    for f in order:
        plen = stamps.prompt[f.rid]
        served.append((f.tokens[:plen], f.tokens[plen:], f.path))
        total += len(f.tokens) - plen
        if total >= tokens:
            break
    return served
