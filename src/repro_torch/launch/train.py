"""Training launcher of the port (``--backend vector``): the quickstart
pipeline corpus -> prefix features -> k-means -> pre-sharding ->
DiLoCo-per-module phases -> routed evaluation.

    # dipaco-150m at full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --levels 2x2 \
        --phases 2 --tau 10

    # the smoke config on the CPU (plain attention and k-means, no kernels)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke

Only the ``vector`` backend of ``repro.launch.train`` is ported; the
mesh, service and barrier backends wait for ROADMAP queue 1, item 3.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.routing import kmeans_assign, kmeans_fit, prefix_features
from repro_torch.data import SyntheticCorpus, shard_documents
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig
from repro_torch.training import make_trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dipaco-150m")
    ap.add_argument("--levels", default="2x2")
    ap.add_argument("--phases", type=int, default=2)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--docs", type=int, default=512)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of --arch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda; it "
                         "raises where there is no card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(route_prefix_len=8)
    if device.type == "cuda":
        cfg = cfg.replace(attn_impl="pallas")
    levels = tuple(int(x) for x in args.levels.split("x"))
    P = int(np.prod(levels))
    print(f"[launch] arch={cfg.name} smoke={args.smoke} levels={levels} "
          f"paths={P} device={device}")

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size,
                             num_domains=max(8, P), seq_len=args.seq, seed=0)
    docs = corpus.sample_documents(args.docs)
    val = corpus.sample_documents(max(args.docs // 8, P), seed=99)
    base = api.init_model(cfg, seed=0, device=device)
    feats = prefix_features(base, cfg, docs)
    gen = torch.Generator(device=device).manual_seed(1)
    cents, assign, _ = kmeans_fit(feats, P, generator=gen)
    ds = shard_documents(docs, assign.cpu().numpy(), P)
    print(f"[launch] shard sizes {ds.sizes.tolist()}")

    dcfg = DiPaCoConfig(levels=levels, inner_steps=args.tau)
    tr = make_trainer(cfg, dcfg, ds, device=device,
                      base_params=base, batch_size=args.batch_size,
                      peak_lr=2e-3, warmup=args.tau,
                      total_steps=args.phases * args.tau)
    t0 = time.time()
    losses = []
    for ph in range(args.phases):
        m = tr.run_phase()
        losses.append(m.mean_loss)
        print(f"[phase {ph}] loss {m.mean_loss:.4f} "
              f"({time.time() - t0:.1f}s)")
    va, _ = kmeans_assign(prefix_features(base, cfg, val), cents)
    res = tr.evaluate_routed(val, va.cpu().numpy())
    print(f"[eval] routed validation PPL {res['ppl']:.2f}")
    print("[done]")
    return {"phase_loss": losses, **res}


if __name__ == "__main__":
    main()
