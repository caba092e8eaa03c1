"""``chip_smoke.py`` phase 12 rehearsed on the CPU at the smoke size.

With ``DEV12 = "cpu"``, ``dipaco-150m``'s smoke config on documents of
64 tokens in place of the paper preset, and fewer documents, steps and
requests, the phase's
control flow runs end to end: (a) ``train_dipaco.run`` with its
re-shard, early stopping, dumps and re-routed evaluation and every check
on them, (b) the six variants with their sharing checks, (c) the other
four examples.  On the card the same functions also check every
kernel's launch count and print the peak memory."""
import gc
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def chip_smoke(monkeypatch, tmp_path):
    from repro_torch.configs import get_smoke_config
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "DEV12", "cpu")
    monkeypatch.setattr(cs, "SHM12", str(tmp_path))
    monkeypatch.setattr(cs, "free_memory", gc.collect)
    # the paper preset at the smoke width, on documents of 64 tokens,
    # its attention through ops (the kernels' plain versions here)
    monkeypatch.setattr(cs.train_dipaco, "preset", lambda name, tau, bs: (
        get_smoke_config("dipaco-150m").replace(attn_impl="pallas"), 64, bs,
        tau))
    monkeypatch.setattr(cs, "ALG1_DOCS", 256)
    monkeypatch.setattr(cs, "ALG1_BATCH", 4)
    monkeypatch.setattr(cs, "ALG1_TAU", 2)
    monkeypatch.setattr(cs, "EXAMPLES12", {
        "quickstart": dict(docs=64, val_docs=16, phases=2, tau=2),
        "serve_paths": dict(docs=64, phases=1, tau=2, router_docs=16,
                            router_steps=5, requests=2, trace_requests=3),
        "train_and_serve": dict(phases=2, docs=32, trace_requests=4),
        "multiarch_smoke": dict(archs=cs.ALL_CONFIGS, steps=3, docs=8)})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cs
    torch.set_num_threads(n)


def test_phase12_rehearses_on_cpu(chip_smoke, monkeypatch):
    # the no-grad attention calls of train_dipaco.run (one a block of
    # each forward), which phase 12 counts as flash-attention launches
    from repro_torch.kernels import ref
    calls, runs = [0], []
    plain, run = ref.flash_attention_ref, chip_smoke.train_dipaco.run

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    def counted_run(**kw):
        before = calls[0]
        out = run(**kw)
        runs.append(calls[0] - before)
        return out

    monkeypatch.setattr(ref, "flash_attention_ref", counted)
    monkeypatch.setattr(chip_smoke.train_dipaco, "run", counted_run)
    out = chip_smoke.phase12("cpu")
    a = out["alg1"]
    assert runs == [a["flash_attention_expected"]]
    assert len(a["phase_losses"]) == chip_smoke.ALG1_PHASES
    assert min(a["shard_sizes_after"]) > 0
    assert a["shard_sizes_after"] != a["shard_sizes_before"]
    assert a["scoring"]["max_abs_err"] <= 1e-3     # plain kernels, f32
    assert a["dumps"]["rows"] == chip_smoke.ALG1_PHASES
    assert a["dumps"]["bit_equal"]
    assert set(a["rerouted"]) == {"once", "every_16", "every_8"}
    assert a["rerouted"]["once"]["switch_rate"] == 0.0
    v = out["variants"]
    assert list(v) == ["diloco", "flat_moe", "path_specific", "sync",
                       "product_kmeans", "flat_moe_top2"]
    for name, res in v.items():
        assert len(res["phases"]) == chip_smoke.VARIANT_PHASES, name
        shared = sum(s["pairs"] for s in res["sharing"])
        assert (shared == 0) == name.startswith("flat_moe"), (name, shared)
    assert v["diloco"]["paths"] == 1 and v["diloco"]["workers"] == 4
    assert len(v["sync"]["clip_scales"]) == \
        chip_smoke.VARIANT_PHASES * chip_smoke.ALG1_TAU
    assert sum(v["flat_moe_top2"]["shard_sizes"]) == 2 * chip_smoke.ALG1_DOCS
    e = out["examples"]
    assert list(e) == ["quickstart", "serve_paths", "train_and_serve",
                       "multiarch_smoke"]
    assert e["train_and_serve"]["swaps"] >= 1
    assert len(e["multiarch_smoke"]["losses"]) == 12
