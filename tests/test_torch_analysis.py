"""The port's analysis package (``repro_torch.analysis``): the lock and
checkpoint-schema passes give the reference's findings over
``src/repro`` fingerprint for fingerprint and nothing over the port;
``torchlint`` flags each of TORCH101-TORCH105 in planted fixtures and
nothing in their clean twins; the command line's gate (baseline reasons, stale
and new entries) and its exit 0 over the repository; and the runtime
lock tracer armed around two of the port's threaded paths on the CPU
(the training service's executors, and the service under transport
faults and fleet chaos), whose static + runtime order graph must stay
acyclic."""
import json
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import Project as JProject
from repro_torch.analysis import (RULE_CATALOG, SEVERITY, Project,
                                  SourceModule, attr_chain)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import ckpt_schema, jaxlint, locks, torchlint

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("check", ["locks", "ckpt_schema"])
def test_passes_give_the_reference_findings_over_repro(check):
    import importlib
    mine = importlib.import_module(f"repro_torch.analysis.{check}").run(
        Project(ROOT, dirs=("src/repro", "benchmarks")))
    theirs = importlib.import_module(f"repro.analysis.{check}").run(
        JProject(ROOT, dirs=("src/repro", "benchmarks")))
    assert [f.to_dict() for f in mine] == [f.to_dict() for f in theirs]


@pytest.mark.parametrize("check", [locks, ckpt_schema])
def test_passes_find_nothing_over_the_port(check):
    project = Project(ROOT, dirs=("src/repro_torch",))
    assert any(m.dotted == "repro_torch.analysis.torchlint"
               for m in project.modules)
    assert check.run(project) == []


def test_shared_pieces_match_the_reference(tmp_path):
    from repro import analysis as ja
    assert {k: v for k, v in RULE_CATALOG.items()
            if not k.startswith("TORCH")} == \
        {k: v for k, v in ja.RULE_CATALOG.items() if not k.startswith("JAX")}
    assert sorted(k for k in RULE_CATALOG if k.startswith("TORCH")) == \
        [f"TORCH10{i}" for i in range(1, 6)]
    assert SEVERITY == ja.SEVERITY
    src = tmp_path / "m.py"
    src.write_text(textwrap.dedent("""\
        import threading
        # analysis: lockfree(single writer)
        X = 1
        def f():  # analysis: ignore[LCK101, TORCH1*](planted)
            return a.b.c
        """))
    mine, theirs = SourceModule(tmp_path, src), ja.SourceModule(tmp_path, src)
    assert {k: [vars(d) for d in v] for k, v in mine.directives.items()} == \
        {k: [vars(d) for d in v] for k, v in theirs.directives.items()}
    node = mine.tree.body[2].body[0].value
    assert attr_chain(node) == ja.attr_chain(node) == ["a", "b", "c"]
    assert jaxlint.run is torchlint.run


# ---------------------------------------------------------------------
# torchlint on planted fixtures
# ---------------------------------------------------------------------

CAPTURED = """\
import random
import time

import numpy as np
import torch

COUNT = 0


def helper(x):
    y = torch.relu(x)
    return float(y.sum())


def tick(g, inp, out):
    with torch.cuda.graph(g):
        y = torch.matmul(inp, inp)
        print("captured")
        t = time.perf_counter()
        r = random.random()
        n = np.random.rand(3)
        if y.sum() > 0:
            out.copy_(y)
        v = y.item()
        z = y.cpu()
        torch.cuda.synchronize()
        a = np.asarray(y)
        helper(y)


@torch.compile
def compiled(x):
    global COUNT
    return x * 2


def step(x):
    return x.tolist()


fast = torch.compile(step)


# analysis: captured
def marked(x):
    while torch.any(x > 0):
        x = x - 1
    return x.numpy()


def loop(fns):
    for f in fns:
        g = torch.cuda.CUDAGraph()
        h = torch.compile(f)


def clean_tick(g, x, mask, host):
    with torch.cuda.graph(g):
        y = torch.relu(x)
        if mask is not None:
            y = torch.where(mask, y, 0)
        n = int(y.shape[0]) + len(y)
        if y.dim() > 1 and isinstance(y, torch.Tensor):
            y = y * n
        w = np.zeros(3) + np.asarray(host)
        k = int(host)
"""

KERNEL = """\
import torch


# analysis: captured
def wrapper(x):
    return int(x.sum().item())
"""

TIMING = """\
import time

import torch


def sync():
    torch.cuda.synchronize()


def bad(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def good(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def good_helper(fn):
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def events(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    start.record()
    fn()
    end.record()
    return start.elapsed_time(end), time.time() - t0
"""


def _planted(tmp_path) -> Project:
    files = {"src/repro_torch/captured.py": CAPTURED,
             "src/repro_torch/kernels/k.py": KERNEL,
             "src/repro_torch/bench.py": TIMING,
             "tools/timing.py": TIMING,
             "chip_smoke.py": TIMING}
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return Project(tmp_path)


def test_torchlint_flags_every_rule_in_planted_fixtures(tmp_path):
    got = {(f.rule, f.path, f.scope, f.detail)
           for f in torchlint.run(_planted(tmp_path))}
    cap = "src/repro_torch/captured.py"
    want = {
        ("TORCH101", cap, "tick", "print"),
        ("TORCH101", cap, "tick", "time.perf_counter"),
        ("TORCH101", cap, "tick", "random.random"),
        ("TORCH101", cap, "tick", "np.random.rand"),
        ("TORCH102", cap, "tick", "if"),
        ("TORCH102", cap, "tick", ".item()"),
        ("TORCH102", cap, "tick", ".cpu()"),
        ("TORCH102", cap, "tick", "synchronize"),
        ("TORCH103", cap, "tick", "np.asarray"),
        ("TORCH102", cap, "helper", "float"),
        ("TORCH101", cap, "compiled", "global"),
        ("TORCH102", cap, "step", ".tolist()"),
        ("TORCH102", cap, "marked", "while"),
        ("TORCH102", cap, "marked", ".numpy()"),
        ("TORCH104", cap, "loop", "torch.cuda.CUDAGraph"),
        ("TORCH104", cap, "loop", "torch.compile"),
        ("TORCH105", "tools/timing.py", "bad", "unsynced-clock"),
        ("TORCH105", "chip_smoke.py", "bad", "unsynced-clock"),
    }
    assert got == want


def test_torchlint_inline_suppression(tmp_path):
    project = _planted(tmp_path)
    p = tmp_path / "src/repro_torch/captured.py"
    p.write_text(p.read_text().replace(
        "        v = y.item()",
        "        v = y.item()  # analysis: ignore[TORCH102](planted)"))
    got = {(f.scope, f.detail) for f in torchlint.run(Project(tmp_path))}
    assert ("tick", ".item()") not in got and ("tick", ".cpu()") in got
    assert project.modules


def test_gate_exits_zero_over_the_repository(capsys):
    assert cli.main(["--gate", "--root", str(ROOT)]) == 0
    out = capsys.readouterr().out
    assert "0 new" in out and "0 stale" in out
    entries = json.loads((ROOT / "analysis/baseline_torch.json").read_text())
    assert entries["findings"]
    assert all(e["reason"].strip() for e in entries["findings"])


def test_gate_fails_on_new_stale_and_unexplained_entries(tmp_path, capsys):
    _planted(tmp_path)
    base = tmp_path / "analysis" / "baseline_torch.json"
    assert cli.main(["--root", str(tmp_path), "--gate"]) == 1
    assert cli.main(["--root", str(tmp_path), "--write-baseline"]) == 0
    assert cli.main(["--root", str(tmp_path), "--gate"]) == 1  # no reason
    data = json.loads(base.read_text())
    for e in data["findings"]:
        e["reason"] = "planted"
    data["findings"].append(dict(data["findings"][0],
                                 fingerprint="TORCH105:gone:x:y"))
    base.write_text(json.dumps(data))
    assert cli.main(["--root", str(tmp_path), "--gate"]) == 1  # stale
    data["findings"].pop()
    base.write_text(json.dumps(data))
    assert cli.main(["--root", str(tmp_path), "--gate"]) == 0
    # rewriting keeps the reasons of the entries that stay
    assert cli.main(["--root", str(tmp_path), "--write-baseline"]) == 0
    assert all(e["reason"] == "planted"
               for e in json.loads(base.read_text())["findings"])
    report = capsys.readouterr().out
    assert "has no reason" in report and "STALE" in report
    cli.main(["--root", str(tmp_path), "--json"])
    js = json.loads(capsys.readouterr().out)
    assert js["new"] == [] and js["summary"]["TORCH105"] == 2


# ---------------------------------------------------------------------
# the lock tracer over the port's threaded paths
# ---------------------------------------------------------------------

SERVICE_LOCKS = {"TrainingService._commit_lock", "TrainingService._clock_cv",
                 "_ExecutorBase._lock", "CheckpointDB._lock",
                 "TaskQueue._lock", "WorkerPool._lock"}


@pytest.mark.parametrize("flags,more", [
    ([], set()),
    (["--transport-retries", "3", "--fault-drop", "0.2", "--fault-seed",
      "3", "--profile", "0:0.5", "--chaos-kill-frac", "0.25",
      "--chaos-phase", "1"],
     {"RetryingTransport._lock", "FaultInjector._lock"}),
], ids=["service", "faults-and-chaos"])
def test_lock_tracer_over_the_service(capsys, monkeypatch, tmp_path, flags,
                                      more):
    """The launcher's training service on the CPU with the tracer armed:
    its executors, checkpoint DB, queue and pool (and with faults, the
    retrying transport and its fault injector) take traced locks, the
    commit lock is taken before the executors' and the DB's, and the
    union of the static and the runtime order graphs is acyclic."""
    from repro_torch.analysis.lock_tracer import LockTracer, _TracedLock
    from repro_torch.launch.train import main
    nodes = []
    init = _TracedLock.__init__

    def counted(self, inner, node, tracer):
        nodes.append(node)
        init(self, inner, node, tracer)

    monkeypatch.setattr(_TracedLock, "__init__", counted)
    tracer = LockTracer.install(ROOT)
    try:
        res = main(["--device", "cpu", "--smoke", "--docs", "64", "--tau",
                    "2", "--phases", "2", "--seq", "48", "--backend",
                    "service", "--ckpt-root", str(tmp_path),
                    "--num-workers", "2", "--comm-dtype", "int8",
                    "--fragments", "2", *flags])
    finally:
        tracer.uninstall()
    assert np.isfinite(res["ppl"]) and "[done]" in capsys.readouterr().out
    assert SERVICE_LOCKS | more <= set(nodes), sorted(set(nodes))
    assert ("TrainingService._commit_lock", "_ExecutorBase._lock") in \
        tracer.runtime_edges
    tracer.check()
    assert not any(t.name.startswith("svc-") and t.is_alive()
                   for t in threading.enumerate())
