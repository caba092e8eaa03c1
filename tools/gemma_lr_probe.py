#!/usr/bin/env python3
"""gemma-2b trained at all 18 blocks and full width as ``chip_smoke.py``'s
phase 11 trains it (``make_trainer(backend="vector")``, levels (1,),
batch 4, 2 phases of 2 inner steps, remat, on the same synthetic
documents), at peak lr 2e-3 warmed up over 1 step and over tau (the
launcher's) and at phase 11's 5e-4, through the attention kernels and
through the plain attention, on the card.

    PYTHONPATH=src python3 tools/gemma_lr_probe.py

A rise of the loss that the plain attention shows as well is not the
kernels' doing.  Prints the card's name and power limit, then one JSON
line a run: its settings, each inner step's loss (phase by phase; the
second phase starts from the outer step) and its peak memory.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import make_trainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticCorpus, shard_documents  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.config import DiPaCoConfig  # noqa: E402

TAU, PHASES, BATCH, DOC_LEN = 2, 2, 4, 1024
# (attention, peak lr, warmup)
RUNS = [("pallas", 2e-3, TAU), ("full", 2e-3, TAU), ("pallas", 2e-3, 1),
        ("full", 2e-3, 1), ("pallas", 5e-4, 1), ("full", 5e-4, 1)]


def run(impl: str, lr: float, warmup: int) -> dict:
    cfg = get_config("gemma-2b").replace(attn_impl=impl, dtype="bfloat16",
                                         remat=True)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DOC_LEN, seed=0)
    docs, domains = corpus.sample_documents(16, seed=1, return_domains=True)
    ds = shard_documents(docs, domains % 1, 1)
    torch.cuda.reset_peak_memory_stats()
    tr = make_trainer(cfg, DiPaCoConfig(levels=(1,), inner_steps=TAU), ds,
                      backend="vector", device="cuda",
                      base_params=api.init_model(cfg, seed=0, device="cuda"),
                      batch_size=BATCH, peak_lr=lr, warmup=warmup,
                      total_steps=PHASES * TAU)
    losses = []
    for _ in range(PHASES):
        m = tr.run_phase()
        # tau 2: the first step's loss from the mean and the last
        losses.append([2 * m.mean_loss - m.final_loss, m.final_loss])
    out = {"attn_impl": impl, "peak_lr": lr,
           "warmup": warmup, "step_losses": losses,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gemma_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for args in RUNS:
        print(json.dumps(run(*args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
