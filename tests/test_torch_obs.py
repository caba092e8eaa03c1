"""The port's copy of the telemetry plane (``repro_torch.obs``) against
the original (``repro.obs``): the same spans, instants and metric samples
in the same trace records (time stamps aside), traces that either
package's reader, validator, summary and Perfetto exporter take alike,
the CLI, and the continuous engine's ``serve.tick`` / ``serve.admit`` /
``serve.preempt`` records against the JAX engine's on the same trace."""
import json

import jax
import numpy as np

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.obs.perfetto import export_perfetto as jexport
from repro.obs.summary import summarize as jsummarize
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import EngineOptions as JOptions
from repro.serving import Request as JRequest
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.models.params import from_numpy_tree
from repro_torch.obs.__main__ import main as tcli
from repro_torch.obs.perfetto import export_perfetto as texport
from repro_torch.obs.summary import summarize as tsummarize
from repro_torch.serving import (PRIO_HIGH, PRIO_PREEMPTIBLE,
                                 ContinuousBatchingEngine, EngineOptions,
                                 Request)

_CLOCK = ("t", "t0", "t1", "pid", "tid", "wall", "mono")


def _untimed(records):
    return [{k: v for k, v in r.items() if k not in _CLOCK}
            for r in records]


def _script(obs, path):
    """One scripted session: spans (nested, with ``set``), a complete
    span, instants, counters, gauges and histograms with labels, sampled
    into the trace."""
    tel = obs.Telemetry(path, meta={"suite": "parity"}, fresh=True)
    reg = tel.metrics
    with tel.span("train.phase", phase=1, shard=0) as sp:
        with tel.span("train.fragment_send", slot=2, nbytes=4096):
            reg.counter("t.sent").inc(3, shard=0)
        sp.set(loss=2.5, steps=4)
    tel.complete_span("serve.swap", 0, policy="drain", version=2)
    tel.instant("serve.admit", path=1, n=3)
    tel.instant("transport.retry", attempt=2, shard=1)
    reg.gauge("t.depth").set(7, path=0)
    for v in (0.5, 3.0, 1e-3):
        reg.histogram("t.lat").observe(v, path=1)
    tel.sample_metrics()
    tel.flush()
    flat = reg.flat()
    tel.close()
    return flat, reg.snapshot()


def test_telemetry_copy_writes_the_reference_records(tmp_path):
    mine = _script(tobs, tmp_path / "t.jsonl")
    theirs = _script(jobs, tmp_path / "j.jsonl")
    assert mine == theirs
    t_recs, t_skip = tobs.read_trace(tmp_path / "t.jsonl")
    j_recs, j_skip = jobs.read_trace(tmp_path / "j.jsonl")
    assert (t_skip, j_skip) == (0, 0)
    assert _untimed(t_recs) == _untimed(j_recs)
    # each package reads, validates and summarizes the other's trace
    assert jobs.validate_trace(t_recs) == [] == tobs.validate_trace(j_recs)
    assert jobs.read_trace(tmp_path / "t.jsonl")[0] == t_recs
    assert jsummarize(t_recs) == tsummarize(t_recs)
    assert tobs.as_telemetry(None) is tobs.NULL
    assert not tobs.NULL.enabled and tobs.NULL.span("x") is \
        tobs.NULL.span("y")


def test_perfetto_export_and_cli_match_reference(tmp_path, capsys):
    _script(tobs, tmp_path / "t.jsonl")
    n_t, _ = texport(str(tmp_path / "t.jsonl"), str(tmp_path / "t.json"))
    n_j, _ = jexport(str(tmp_path / "t.jsonl"), str(tmp_path / "j.json"))
    assert n_t == n_j > 0
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    assert tcli(["validate", str(tmp_path / "t.jsonl")]) == 0
    assert tcli(["summary", "--json", str(tmp_path / "t.jsonl")]) == 0
    out = capsys.readouterr().out
    assert "0 schema errors" in out and '"train.phase": 1' in out
    assert tcli(["export", str(tmp_path / "t.jsonl"), "-o",
                 str(tmp_path / "cli.json")]) == 0
    assert (tmp_path / "cli.json").exists()


def test_engine_trace_matches_reference_engine(tmp_path):
    """The same preempting trace through both engines with telemetry on:
    the same ``serve.*`` records with the same arguments, in order; the
    reference's validator and summary take the port's trace."""
    jcfg = jsmoke("dipaco-150m").replace(route_prefix_len=8)
    tcfg = tsmoke("dipaco-150m").replace(route_prefix_len=8)
    key = jax.random.PRNGKey(0)
    jp = [japi.init_model(key, jcfg)[0],
          japi.init_model(jax.random.fold_in(key, 1), jcfg)[0]]
    tp = [from_numpy_tree(jax.tree_util.tree_map(np.asarray, p),
                          device="cpu") for p in jp]
    rng = np.random.default_rng(3)
    reqs = [dict(rid=i, prompt=rng.integers(0, 512, 8 + 4 * (i % 2)),
                 max_new=4 + i, path=i % 2, arrival=0.002 * i,
                 priority=PRIO_HIGH if i % 3 == 2 else PRIO_PREEMPTIBLE)
            for i in range(6)]
    traces = {}
    for name, obs, eng_cls, opt_cls, req_cls, cfg, paths in (
            ("jax", jobs, JEngine, JOptions, JRequest, jcfg, jp),
            ("torch", tobs, ContinuousBatchingEngine, EngineOptions,
             Request, tcfg, tp)):
        tel = obs.Telemetry(tmp_path / f"{name}.jsonl", fresh=True)
        eng = eng_cls(cfg, paths, options=opt_cls(
            cache_len=32, slots_per_path=1, telemetry=tel))
        eng.serve_trace([req_cls(**r) for r in reqs])
        tel.close()
        traces[name] = jobs.read_trace(tmp_path / f"{name}.jsonl")[0]
    mine, theirs = (_untimed(traces[k]) for k in ("torch", "jax"))
    assert mine == theirs
    names = {r["name"] for r in mine if "name" in r}
    assert {"serve.tick", "serve.admit", "serve.preempt"} <= names
    assert jobs.validate_trace(traces["torch"]) == []
    summary = jsummarize(traces["torch"])
    assert summary["names"]["serve.tick"] == \
        sum(r.get("name") == "serve.tick" for r in mine)
    assert summary["swap_dips"]["ticks_steady"] == \
        summary["names"]["serve.tick"]


def test_engine_without_telemetry_takes_the_null_handle():
    cfg = tsmoke("dipaco-150m").replace(route_prefix_len=8)
    from repro_torch.models import api
    eng = ContinuousBatchingEngine(
        cfg, [api.init_model(cfg, seed=0, device="cpu")],
        options=EngineOptions(cache_len=24, slots_per_path=1))
    assert eng.tel is tobs.NULL
    fins = eng.serve_trace([Request(rid=0, prompt=np.arange(8), max_new=3)])
    assert len(fins) == 1 and len(fins[0].tokens) == 11
