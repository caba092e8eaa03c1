"""Training cells: DiPaCo (Algorithm 1) through
``repro_torch.training.make_trainer(backend="vector")``.

Set-up: the seed's documents and weights; with more than one path, the
documents' prefix features (``core.routing.prefix_features``), k-means
over them (``kmeans_fit``, the ``router_assign`` kernel) and the shards
(``shard_documents``); the trainer; then its first phase of
``check_steps`` inner steps and the outer step, through the window's own
``run_phase``, read for the comparison.  The window runs ``run_phase``
back to back until ``--seconds`` have passed, and ends with the last
phase, with set-up's objects frozen out of the collector's reach
(``hostload.Window``); each phase's time and the host's readings over
the window go to standard error.  With
``--trace 1`` the window times each inner and outer step between two
synchronizes, and whole phases after it, untimed, are the profiler's
slice.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import devtrace, generator, hostload, sketch, weights
from bench.devtrace import Slice, device_sync, span
from bench.harness import Run
from bench.tools import faults as fault_lib


class StepTap:
    """Wraps the trainer's inner step: keeps each call's per-worker
    losses (on the device, no sync), and after the first call the
    per-leaf norms of the gradient the optimizer got, read back from its
    first moment (m = (1 - b1) g from zero), and its sketch
    (``bench/sketch.py``).  With ``timed`` each call
    is timed on the host clock between two synchronizes; each runs in a
    ``bench.train.inner_step`` span (``devtrace.span``)."""

    def __init__(self, fn, seed: int, *, timed: bool = False):
        self.fn, self.seed, self.timed = fn, seed, timed
        self.losses, self.first_grad, self.seconds = [], None, []
        self.first_sketch = None

    def __call__(self, worker_params, opt_state, batch, lr):
        if self.timed:
            device_sync()
            t0 = time.perf_counter()
        with span("bench.train.inner_step"):
            out = self.fn(worker_params, opt_state, batch, lr)
        if self.timed:
            device_sync()
            self.seconds.append(time.perf_counter() - t0)
        self.losses.append(out[2]["loss"].detach().float())
        if self.first_grad is None:
            grad = {k: v / 0.1 for k, v in weights.flat(out[1]["m"]).items()}
            w_count = out[2]["loss"].shape[0]
            self.first_grad = [
                {k: float(torch.linalg.vector_norm(v[w].double()))
                 for k, v in grad.items()} for w in range(w_count)]
            proj = sketch.projections(grad, self.seed, rows=w_count)
            self.first_sketch = [{k: v[w] for k, v in proj.items()}
                                 for w in range(w_count)]
            del grad
        return out


class Timed:
    """A method timed between two synchronizes, in a span."""

    def __init__(self, fn, label: str):
        self.fn, self.label, self.seconds = fn, label, []

    def __call__(self, *args, **kw):
        device_sync()
        t0 = time.perf_counter()
        with span(self.label):
            out = self.fn(*args, **kw)
        device_sync()
        self.seconds.append(time.perf_counter() - t0)
        return out


def program_config(m: dict):
    from repro_torch.models.config import BlockSpec, ModelConfig
    fields = dict(m)
    fields["pattern"] = tuple(BlockSpec(*p) for p in m["pattern"])
    return ModelConfig(**fields)


def run(spec, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, faults=()) -> Run:
    from repro_torch.core.routing.features import prefix_features
    from repro_torch.core.routing.kmeans import kmeans_fit
    from repro_torch.data.sharder import shard_documents
    from repro_torch.kernels import build
    from repro_torch.models.config import DiPaCoConfig
    from repro_torch.models.params import param_shapes
    from repro_torch.training import make_trainer

    m, mix = spec.model, spec.mix
    cfg = program_config(m)
    weights.check_layout(m, param_shapes(cfg))
    if device == "cuda":
        build.build()                   # every kernel, in parallel, once
    w_count = int(np.prod(mix["levels"]))
    docs = generator.corpus_documents(mix, m["vocab_size"], mix["docs"], seed)
    base = weights.make_paths(m, seed, 1, device)[0]
    if w_count > 1:
        feats = prefix_features(base, cfg, docs)
        gen = torch.Generator(device=device).manual_seed(seed)
        _, assign, _ = kmeans_fit(feats, w_count, iters=mix["kmeans_iters"],
                                  generator=gen)
        assign = assign.cpu().numpy()
        del feats
    else:
        assign = np.zeros(len(docs), np.int64)
    ds = shard_documents(docs, assign, w_count)
    dcfg = DiPaCoConfig(levels=tuple(mix["levels"]),
                        inner_steps=mix["tau"])
    tr = make_trainer(cfg, dcfg, ds, backend="vector", device=device,
                      base_params=base, batch_size=mix["batch"],
                      peak_lr=mix["peak_lr"], warmup=mix["warmup"],
                      total_steps=mix["total_steps"])
    unplant = fault_lib.plant_trainer(faults, tr)
    tap = tr._step_fn = StepTap(tr._step_fn, seed)
    tr.run_phase(tau=mix["check_steps"])
    flat_base = weights.flat(base)
    glob = weights.flat(tr.global_params)
    changes = [{k: float(torch.linalg.vector_norm(
        (glob[k][w] - flat_base[k].float()).double())) for k in glob}
        for w in range(w_count)]
    readings = {"losses": torch.stack(tap.losses).cpu().numpy(),
                "grad_norms": tap.first_grad, "sketches": tap.first_sketch,
                "changes": changes}
    del base, flat_base, glob
    tap.losses = []
    out = Run(spec)
    outer = tr._outer
    if trace:
        tap.timed = True
        tr._outer = Timed(outer, "bench.train.outer")
    device_sync()
    out.e2e["setup_s"] = time.perf_counter() - t_start

    phase_s = []
    with hostload.Window() as host:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t1 = time.perf_counter()
            tr.run_phase()            # ends with its losses on the host
            phase_s.append(time.perf_counter() - t1)
        device_sync()
        out.window_s = time.perf_counter() - t0
    out.notes.append(host.line(phase_s=[round(x, 3) for x in phase_s]))
    steps = len(phase_s) * mix["tau"]
    tokens = steps * w_count * mix["batch"] * mix["doc_len"]
    out.e2e["train_tokens_per_s"] = tokens / out.window_s
    losses = torch.stack(tap.losses)
    out.attempted = int(losses.numel())
    out.failed = int((~torch.isfinite(losses)).sum())
    out.work.update(tokens=tokens, steps=steps, workers=w_count,
                    batch=mix["batch"], seq_len=mix["doc_len"])
    out.host = {"inner_step_s": tap.seconds,
                "outer_step_s": getattr(tr._outer, "seconds", [])}
    if trace:
        # the traced slice after the window: whole phases, untimed, for
        # at least SLICE_S
        tap.timed = False

        def spanned_outer():
            with span("bench.train.outer"):
                return outer()

        tr._outer = spanned_outer
        tracer, traced = Slice(), 0
        tracer.begin()
        while tracer.elapsed() < devtrace.SLICE_S:
            with span("bench.train.phase"):
                tr.run_phase()
            traced += 1
        out.trace = tracer.read()
        out.trace_window_s = tracer.window_s
        out.work["traced_tokens"] = traced * mix["tau"] * w_count * \
            mix["batch"] * mix["doc_len"]
    if device == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()

    unplant()
    del tr, ds, tap, outer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    from bench.reference import checks
    want = checks.train_readings(m, mix, seed, assign, device)
    if "control" in faults:
        readings = checks.train_readings(m, mix, seed, assign, device,
                                         precision="fp8")
    out.numbers = checks.train_numbers(readings, want)
    return out
