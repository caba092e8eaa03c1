"""Running one cell: the spec found by name in files, the device check,
the driver, the verdict, and the result line.

Every file is found by the cell's name: its entry in ``BENCHMARK.json``
names the configuration and the traffic mix; ``configs/<config>.json``,
``traffic/<mix>.json`` and ``cells/<cell>.json`` (the comparison's
limits) hold the data, and ``metrics/<metric>.py`` the reader of each
per-layer metric.  Nothing here names a cell.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Spec:
    """One cell with everything found for it."""
    cell: dict                  # the BENCHMARK.json workload entry
    config: dict                # configs/<config>.json
    mix: dict                   # traffic/<mix>.json
    limits: dict                # cells/<cell>.json "limits"
    end_to_end: list            # BENCHMARK.json metrics the cell reports
    per_layer: list
    bench_dir: Path = BENCH

    @property
    def model(self) -> dict:
        return self.config["model"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(entry: dict, cell: str, e2e_names=None) -> bool:
    """Whether a metric entry is reported in ``cell``: listed there, or
    listing no cells and moving a metric the cell reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if e2e_names is None:
        return True
    return entry.get("moves") in e2e_names


def load_spec(name: str, benchmark=ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH) -> Spec:
    """The cell ``name`` of ``benchmark`` (a path, or its loaded dict)
    with every file found for it."""
    top = benchmark if isinstance(benchmark, dict) else load_json(benchmark)
    cells = {w["name"]: w for w in top["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {benchmark}")
    cell = cells[name]
    config = load_json(bench_dir / "configs" / f"{cell['config']}.json")
    mix = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(bench_dir / "cells" / f"{name}.json")["limits"]
    e2e = [m for m in top["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in top["per_layer"] if reports(m, name, names)]
    return Spec(cell, config, mix, limits, e2e, per_layer, bench_dir)


def reader(name: str, bench_dir: Path = BENCH):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The driver module of a traffic kind (``drivers/<kind>.py``)."""
    return importlib.import_module(f"bench.drivers.{kind}")


@dataclass
class Run:
    """What a driver hands back.  ``e2e`` holds the end-to-end numbers it
    measured; ``host`` the host-clock series of the traced run and
    ``trace`` its device trace over a slice of ``trace_window_s`` seconds
    (None without ``--trace 1``); ``work`` the
    counts the readers need; ``numbers`` what the reference compared;
    ``notes`` lines for standard error (the window's host readings)."""
    spec: Spec
    e2e: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    window_s: float = 0.0
    host: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    trace: object = None
    trace_window_s: float = 0.0
    numbers: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)


def loaded_forbidden() -> list:
    """Top-level module names of JAX, Flax or the JAX package in
    ``sys.modules`` (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def finite(x) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


def e2e_value(run: Run, name: str):
    """An end-to-end metric as the cell's driver (``drivers/<kind>.py``)
    read it: ``name``, or for a cell's own variant ``<metric>.<qualifier>``
    (one bound for cells that spread alike) the driver's ``<metric>``."""
    if name in run.e2e:
        return run.e2e[name]
    return run.e2e.get(name.split(".")[0])


def result_line(spec: Spec, run: Run, trace: bool, correct: bool,
                table: dict, device: dict) -> dict:
    """The result object: the cell's end-to-end metrics (``--trace 0``)
    or its per-layer metrics (``--trace 1``) that have a reading."""
    metrics = {}
    entries = spec.per_layer if trace else spec.end_to_end
    for m in entries:
        value = reader(m["name"], spec.bench_dir)(run) if trace \
            else e2e_value(run, m["name"])
        if finite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["limits"] = table
    return out


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(spec: Spec, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, faults=()) -> tuple:
    """Run the cell's driver and decide ``correct`` -> (run, correct,
    table).  ``faults`` names faults to plant (``tools/faults.py``)."""
    run = driver(spec.mix["kind"]).run(spec, seed=seed, seconds=seconds,
                                       trace=trace, device=device,
                                       t_start=t_start, faults=faults)
    from bench.reference.compare import verdict
    correct, table = verdict(run.numbers, spec.limits)
    return run, correct, table


def main(argv, t_start: float) -> int:
    args = parse(argv)
    spec = load_spec(args.workload)
    import torch
    torch.set_num_threads(4)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run, correct, table = execute(spec, args.seed, args.seconds,
                                  bool(args.trace), "cuda", t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"the process loaded {bad}: the benchmark runs the port "
              f"without JAX or the JAX package", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit": power_limit()}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace_window_s
    out = result_line(spec, run, bool(args.trace), correct, table, device)
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, (value, limit) in table.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
