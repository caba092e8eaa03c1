"""``chip_smoke.py`` phase 11 rehearsed on the CPU at the smoke size.

With ``DEV11 = "cpu"`` and the smoke configs the phase's control flow
runs end to end: each decoder family served through the one-shot engine
(the plain pass) and checked against the plain path in bf16 and
f32, pixtral's patch prefill, whisper-base through ``models.api`` with
and without the cross K/V, the dense baseline and gemma-2b trained for
two phases, and the gradient checks (gemma-2b's, nemotron-4-340b's and
qwen3-moe-235b-a22b's among them).  On the card the same functions also check
every kernel's launch count, profile a generate and print the peak
memory."""
import gc
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def chip_smoke(monkeypatch):
    from repro_torch.configs import get_smoke_config
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "DEV11", "cpu")
    monkeypatch.setattr(cs, "get_config", get_smoke_config)
    monkeypatch.setattr(cs, "free_memory", gc.collect)
    # documents of 128 tokens (the smoke configs' route prefix is 32),
    # 64 of them for the dense baseline; pixtral's smoke config has 16
    # patch positions
    monkeypatch.setattr(cs, "DOC_LEN", 128)
    monkeypatch.setattr(cs, "DENSE_DOCS", 64)
    monkeypatch.setattr(cs, "GRAD_PATCHES", 16)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cs
    torch.set_num_threads(n)


def test_phase11_rehearses_on_cpu(chip_smoke):
    out = chip_smoke.families11()
    names = [f[0] for f in chip_smoke.FAMILIES11]
    assert set(out) == {*names, "whisper-base", "seconds"}
    for name, paths, depth, f32_depth in chip_smoke.FAMILIES11:
        fam = out[name]
        served = fam["serve"]["plain"]
        assert fam["paths"] == paths and len(served["paths"]) == 8
        assert served["decode_steps"] > 0 and "reroute" not in fam["serve"]
        calls = {c.split(":")[0] for c in served["launches_by_call"]}
        assert calls == {"decode", "features"}
        assert fam["parity"]["float32"]["blocks"] == f32_depth
        assert fam["parity"]["bfloat16"]["blocks"] == fam["blocks"]
    assert out["jamba-v0.1-52b"]["blocks"] == 8
    patches = out["pixtral-12b"]["patches"]
    assert patches["patches"] == 16 and patches["max_abs_dlogit"] <= 0.25
    whisper = out["whisper-base"]
    assert whisper["max_abs_dlogit_cross_kv"] <= 1e-5     # f32 smoke
    assert whisper["cross_kv"]["decode_steps"] == 32
    assert set(whisper["parity"]) == {"bfloat16", "float32"}
    train = out["dipaco-dense-1b"]["train"]
    assert train["workers"] == 1 and len(train["phases"]) == 2
    assert train["phases"][1]["mean_loss"] < train["phases"][0]["mean_loss"]
    gemma = out["gemma-2b"]["train"]
    assert (gemma["workers"], gemma["paths"], gemma["batch"]) == (
        1, 1, chip_smoke.GEMMA_TRAIN_BATCH)
    assert gemma["blocks"] == 2 and len(gemma["phases"]) == 2
    assert gemma["phases"][1]["mean_loss"] < gemma["phases"][0]["mean_loss"]
    want = {}
    for name, depth, dtypes in chip_smoke.GRAD11:
        for dt in dtypes:
            want.setdefault(name, {})[dt] = depth
    for name, depths in want.items():
        grads = out[name]["train_grad_parity"]
        assert {dt: g["blocks"] for dt, g in grads.items()} == depths
        assert all(g["max_rel_err"] <= g["tol"] for g in grads.values())
    # the kernels' launch counts of the card fill phase 2's rows
    rows = [{"name": n, "shape": shape} for n, shape in (
        ("flash_decode:gqa-d128:b8", [8, 32, 8, 128, 80]),
        ("flash_decode:gqa-d128:b4", [4, 32, 8, 128, 80]),
        ("flash_attention_lse:dipaco-dense-1b", [8, 1024, 16, 16, 128]),
        ("expert_gemm:moonshot-v1-16b-a3b:decode", [64, 8, 2048, 1408]),
        ("expert_gemm:jamba-v0.1-52b:routing", [16, 40, 4096, 14336]),
        ("expert_gemm_dw:jamba-v0.1-52b:train", [16, 320, 4096, 14336]),
        ("flash_decode:gemma-2b:b3", [3, 8, 1, 256, 80]),
        ("flash_decode:qwen3-moe-235b-a22b:b8", [8, 64, 4, 128, 80]),
        ("flash_attention:nemotron-4-340b:routing", [8, 32, 96, 8, 192]),
        ("flash_attention_dkv:gemma-2b", [8, 1024, 8, 1, 256]),
        ("flash_attention_dq:nemotron-4-340b", [2, 1024, 96, 8, 192]),
        ("flash_attention_lse:qwen3-moe-235b-a22b", [2, 1024, 64, 4, 128]),
        ("expert_gemm:qwen3-moe-235b-a22b:decode", [128, 8, 4096, 1536]))]
    chip_smoke.family_launches(rows, out)
    assert all(r["launches"] == 0 for r in rows)          # no card here
