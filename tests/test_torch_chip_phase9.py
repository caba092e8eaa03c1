"""``chip_smoke.py`` phase 9 rehearsed on the CPU at the smoke size.

With ``DEV9 = "cpu"`` the phase's control flow runs end to end: the
deploy plane over 4 paths (an outer phase published through the canary,
the drain swap against a fresh engine and v1, the planted candidate
quarantined, the live rollback bit for bit, the one-shot engine's
poll), training beside serving with the publisher's background thread,
and a fleet of two spawned CPU members against the in-process fleet,
under its byte budget.  On the card the same function also checks the
CUDA graph, the launch counts and the profiler's replays."""
import gc
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def chip_smoke(monkeypatch, tmp_path):
    from repro_torch.configs import get_smoke_config
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "DEV9", "cpu")
    monkeypatch.setattr(cs, "get_config", get_smoke_config)
    monkeypatch.setattr(cs, "free_memory", gc.collect)
    monkeypatch.setattr(cs, "PHASE9_DIR", tmp_path / "phase9")
    return cs


def test_phase9_rehearses_on_cpu(chip_smoke):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticCorpus, shard_documents
    from repro_torch.models import api
    cfg = get_smoke_config("dipaco-150m").replace(attn_impl="pallas",
                                                  route_prefix_len=8)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=64, seed=0)
    docs, doms = corpus.sample_documents(256, return_domains=True)
    base = api.init_model(cfg, seed=0, device="cpu")
    out = chip_smoke.deploy("cpu", cfg, shard_documents(docs, doms % 4, 4),
                            base, 0.0)
    swaps, training, fleet = out["swaps"], out["training"], out["fleet"]
    assert swaps["drain"]["equal_to_fresh_v2"] == 4
    assert swaps["drain"]["differ_from_v1"] > 0
    assert swaps["planted"]["rejected"] == 3
    assert swaps["live"]["flagged"] == swaps["live"]["in_flight"] > 0
    assert len(swaps["install_s"]) == 2
    assert training["published"] == 1 and training["cycle_errors"] == 0
    assert fleet["tokens_equal"] == fleet["requests"] == 8
    assert fleet["exitcodes"] == [0, 0]
    assert 0 < out["written_gb"] < 0.1
