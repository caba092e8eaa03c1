"""``chip_smoke.py`` phase 10 rehearsed on the CPU at the smoke size.

``mesh(..., dev="cpu")`` runs the phase's control flow end to end: (a)
the mesh trainer in a world of one (gloo here, NCCL on the card) for 2
phases against the single-process oracle bit for bit, (b) two spawned
gloo ranks against (a) bit for bit, (c) kill and resume from the
phase-state files (here under the test's temporary directory).  On the
card the same function also checks the launch counts, the peak memory
and the profiled gathers."""
import gc
import importlib.util
import sys
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
    # the spawned ranks import chip_smoke by name to find their entry
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(cs, "get_config", get_smoke_config)
    monkeypatch.setattr(cs, "free_memory", gc.collect)
    monkeypatch.setattr(cs, "MESH_SHM", tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks take the parent's count
    yield cs
    torch.set_num_threads(n)


def test_phase10_rehearses_on_cpu(chip_smoke):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticCorpus, shard_documents
    from repro_torch.models import api
    cfg = get_smoke_config("dipaco-150m").replace(attn_impl="pallas",
                                                  route_prefix_len=8)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=64, seed=0)
    docs, doms = corpus.sample_documents(256, return_domains=True)
    base = api.init_model(cfg, seed=0, device="cpu")
    out = chip_smoke.mesh("cpu", cfg, shard_documents(docs, doms % 4, 4),
                          base, dev="cpu")
    one, two, res = out["one"], out["two_ranks"], out["resume"]
    assert one["oracle_differences"] == {}
    assert one["oracle_leaves"]["residuals"] == one["oracle_leaves"][
        "global"] > 0
    assert one["wire_bytes_int8"] * 3 < one["wire_bytes_fp32"]
    assert two["paths_equal"] == [True] * 4 and two["rows_of_rank0"] == [0, 1]
    assert res["files"] == ["mesh_phase_000001.npz", "mesh_phase_000002.npz"]
    assert res["differences"] == {} and all(res["paths_equal"])
    assert not any(chip_smoke.MESH_SHM.iterdir())      # removed
