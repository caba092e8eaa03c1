"""The harness: cells, configurations, mixes and metrics found by name
from files; the required shape of ``BENCHMARK.json``; the window's
statistics; the frozen FLOP count; the import guard."""
import ast
import json
import re
import shutil
import time

import numpy as np
import pytest

from bench import flops, harness
from bench.drivers import serve

from .conftest import ROOT, benchmark, smoke_spec

TOP = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell",
                         [w["name"] for w in benchmark()["workloads"]])
def test_cell_found_by_name(cell):
    spec = harness.load_spec(cell, benchmark())
    conf = {c["name"]: c for c in TOP["configs"]}[spec.cell["config"]]
    assert (ROOT / conf["file"]).resolve() == \
        (harness.BENCH / "configs" / f"{spec.cell['config']}.json").resolve()
    assert spec.config["name"] == spec.cell["config"]
    assert harness.driver(spec.mix["kind"]).run
    assert spec.limits
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in names


def test_benchmark_json_has_the_required_shape():
    assert set(TOP) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert TOP["paths"] == ["bench"] and 1 <= TOP["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in TOP[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in TOP["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and c["reduced"] == []
    pairs = set()
    for w in TOP["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in TOP["end_to_end"] + TOP["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in TOP["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert len(json.dumps(TOP)) < 64 * 1024


def test_a_throwaway_cell_is_found_by_name(tmp_path):
    """A new cell, configuration, mix and per-layer metric take only new
    files: here a copy of the benchmark's directory gains one of each,
    and a run of the new cell on the CPU reports the new metric."""
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(harness.BENCH / sub, bench / sub)
    conf = json.loads((bench / "configs" / "dipaco-150m.json").read_text())
    conf["name"] = conf["model"]["name"] = "tiny"
    conf["model"].update(
        {k: v for k, v in smoke_spec("serve-150m-chat").model.items()
         if k != "name"})
    (bench / "configs" / "tiny.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "chat.json").read_text())
    mix.update(prompt_lens=[32], max_new=[4], doc_len=32, slots=2,
               cache_len=64, router_docs=32, check_tokens=8, rate=10.0)
    (bench / "traffic" / "tiny-chat.json").write_text(json.dumps(mix))
    (bench / "cells" / "tiny-cell.json").write_text(
        json.dumps({"limits": {"logit_gap": 0.01, "route_gap": 0.1}}))
    (bench / "metrics" / "emitted.tiny.py").write_text(
        "def read(run):\n    return float(run.work['emitted'])\n")
    top = json.loads(json.dumps(TOP))
    top["configs"].append({"name": "tiny", "source": "x",
                           "file": "bench/configs/tiny.json",
                           "reduced": [], "why": "x"})
    top["workloads"].append({"name": "tiny-cell", "config": "tiny",
                             "traffic": "tiny-chat", "chips": 1, "why": "x"})
    top["per_layer"].append({"name": "emitted.tiny", "unit": "tokens",
                             "better": "higher", "source": "program_counter",
                             "layer": "Engine", "moves": "serve_tokens_per_s",
                             "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(top))
    spec = harness.load_spec("tiny-cell", tmp_path / "BENCHMARK.json", bench)
    assert [m["name"] for m in spec.per_layer] == ["emitted.tiny"]
    run, correct, table = harness.execute(spec, 2 ** 31 + 5, 1.0, True,
                                          "cpu", time.perf_counter())
    out = harness.result_line(spec, run, True, correct, table,
                              {"platform": "cpu"})
    assert correct and out["metrics"]["emitted.tiny"]["value"] > 0
    assert list(out)[-1] == "limits"


def test_tails_take_every_request_and_a_missing_one_is_infinite():
    st = serve.Stamps()
    for rid in range(40):
        st.submit(rid, due=0.1 * rid, prompt_len=8)
        st.first[rid] = 0.1 * rid + 0.01 * (rid + 1)
        st.new[rid] = 5
        st.done[rid] = st.first[rid] + 0.4
    t = serve.tails(st)
    ttft = [0.01 * (r + 1) for r in range(40)]
    assert t["attempted"] == 40 and t["failed"] == 0
    assert t["ttft_p95_ms"] == pytest.approx(np.percentile(ttft, 95) * 1e3)
    assert t["tpot_p95_ms"] == pytest.approx(100.0)
    for rid in range(38, 40):        # two of forty never finish
        del st.done[rid], st.first[rid]
    t = serve.tails(st)
    assert t["failed"] == 2 and np.isinf(t["ttft_p95_ms"])
    assert serve.percentile([1.0, 2.0, np.inf], 50) == 2.0


def test_window_rate_counts_every_token_of_the_window():
    """Tokens a step emits are counted once, from the engine's state;
    the requests in flight are counted after each step, by path."""

    class St:
        def __init__(self, rid, n):
            self.req = type("R", (), {"rid": rid})
            self.tokens = [0] * n
            self.path = rid % 2

    class Eng:
        in_flight = {}

    st = serve.Stamps()
    st.submit(1, 0.0, 3)
    st.submit(2, 0.0, 3)
    Eng.in_flight = {1: St(1, 4), 2: St(2, 3)}
    st.after_step(Eng, [], 0.5)
    Eng.in_flight = {1: St(1, 5), 2: St(2, 4)}
    st.after_step(Eng, [], 0.6)
    assert st.emitted == 3 and st.first == {1: 0.5, 2: 0.6}
    assert st.live == [2, 2] and st.live_path_max == {0: 1, 1: 1}


def test_the_window_times_its_collections_and_reads_the_host():
    import gc

    from bench import hostload
    with hostload.Window() as host:
        for _ in range(100):
            a = []
            a.append(a)             # a cycle only the collector frees
        del a
        gc.collect()
    r = host.readings
    assert r["gc_by_generation"][2] >= 1 and r["gc_s"] > 0
    assert r["wall_s"] > 0 and r["cpu_share"] >= 0 and r["nivcsw"] >= 0
    assert host._on_gc not in gc.callbacks
    assert host.line(phase_s=[1.5]).startswith("host: wall_s ")


def test_an_architecture_is_found_by_its_arch_type(monkeypatch):
    """A configuration of another architecture brings its reference as
    one new file, ``reference/<arch_type>.py``: the weight layout and
    the reference model are looked up by that name."""
    import sys

    from bench import weights
    from bench.reference import dense, model
    monkeypatch.setitem(sys.modules, "bench.reference.tinyarch", dense)
    m = {**smoke_spec("train-150m-2x2").model, "arch_type": "tinyarch"}
    assert model.family(m) is dense
    assert weights.leaf_specs(m) == dense.leaf_specs(m)
    tree = weights.flat(weights.make_paths(m, 3, 1, "cpu")[0])
    assert isinstance(model.build(tree, m), dense.Model)
    with pytest.raises(ModuleNotFoundError):
        model.family({**m, "arch_type": "no_such_arch"})


@pytest.mark.parametrize("config", ["dipaco-150m", "dipaco-dense-1b"])
def test_frozen_flops_match_the_programs_flopmodel(config):
    from repro_torch.launch.flopmodel import analyze
    from repro_torch.models.config import InputShape

    from bench.drivers.train import program_config
    m = json.loads((harness.BENCH / "configs" / f"{config}.json")
                   .read_text())["model"]
    for s, b in ((1024, 8), (4096, 256)):
        want = analyze(program_config(m), InputShape("t", s, b, "train"))
        got = flops.forward_flops_per_token(m, float(s)) * s * b
        assert got == pytest.approx(want.fwd_flops, rel=1e-12)
    assert flops.train_flops(m, 8 * 1024, 1024) < 3 * want.fwd_flops


def imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module)
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        top = {n.split(".")[0] for n in imports(path)}
        assert not top & set(harness.FORBIDDEN), (path, top)


def test_the_reference_imports_nothing_of_the_program():
    """bench/reference and the bench modules it reaches import no
    module of repro_torch."""
    seen, todo = set(), [p for p in (harness.BENCH / "reference").glob("*.py")]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imports(path):
            assert name.split(".")[0] not in ("repro_torch",) + \
                harness.FORBIDDEN, (path, name)
            if name.split(".")[0] == "bench":
                mod = ROOT / (name.replace(".", "/") + ".py")
                todo += [mod] if mod.exists() else \
                    list((ROOT / name.replace(".", "/")).glob("*.py"))
    assert any(p.name == "generator.py" for p in seen)


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.x", object())
    assert "repro" in harness.loaded_forbidden()


def test_run_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "train-150m-2x2", "--seed", "1",
                       "--seconds", "1"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


class _Event:
    def __init__(self, name, t0, dt, cuda=True):
        self._name, self._t0, self._dt, self._cuda = name, t0, dt, cuda

    def name(self):
        return self._name

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._dt

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._cuda \
            else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


def test_the_trace_moves_host_spans_onto_its_clock_by_the_marker():
    """Device time is the union of the device operations; each idle gap
    is put down to the host span open at its middle, the host's clock
    moved onto the trace's by the marker kernel."""
    from types import SimpleNamespace

    from bench import devtrace
    events = [_Event("at::cuda::(anonymous namespace)::spin_kernel(long)",
                     1000, 1),
              _Event("a", 1000, 10), _Event("b", 1005, 15),
              _Event("c", 1050, 10), _Event("d", 1100, 10),
              _Event("cudaLaunchKernel", 1000, 200, cuda=False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [("bench.x", 15, 70), ("bench.y", 70, 120)]
    tr = devtrace.DeviceTrace.from_profile(prof, spans, marker_ns=0)
    assert [op[0] for op in tr.ops] == ["a", "b", "c", "d"]
    assert tr.busy_s() == pytest.approx(40e-9)
    assert tr.idle_gaps() == [["bench.y", pytest.approx(40e-9)],
                              ["bench.x", pytest.approx(30e-9)]]
    assert devtrace.DeviceTrace.from_profile(prof, spans).notes == []


def test_spans_are_kept_only_while_a_slice_records():
    from types import SimpleNamespace

    from bench import devtrace
    with devtrace.span("bench.off"):
        pass
    rec = SimpleNamespace(spans=[])
    devtrace._ACTIVE[:] = [rec]
    try:
        with devtrace.span("bench.on"):
            pass
    finally:
        devtrace._ACTIVE[:] = []
    assert [s[0] for s in rec.spans] == ["bench.on"]
    assert rec.spans[0][1] <= rec.spans[0][2]


def test_a_cells_own_end_to_end_metric_reads_the_drivers_reading():
    """``train_tokens_per_s.dense`` is the training driver's
    ``train_tokens_per_s`` in the cell that lists it."""
    spec = harness.load_spec("train-dense1b")
    run = harness.Run(spec, e2e={"setup_s": 1.5, "train_tokens_per_s": 5.0})
    out = harness.result_line(spec, run, False, True, {}, {})
    assert out["metrics"] == {
        "setup_s": {"value": 1.5, "unit": "s"},
        "train_tokens_per_s.dense": {"value": 5.0, "unit": "tokens/s"}}
    assert harness.e2e_value(run, "serve_tokens_per_s.chat") is None
