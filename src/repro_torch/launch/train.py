"""Training launcher of the port: the quickstart pipeline corpus ->
prefix features -> k-means -> pre-sharding -> DiLoCo-per-module phases
-> routed evaluation, through ``make_trainer(backend=...)``.

    # dipaco-150m at full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --levels 2x2 \
        --phases 2 --tau 10

    # the §3 service: 4 pool threads, staleness window 1, int8 wire
    PYTHONPATH=src python -m repro_torch.launch.train --backend service \
        --num-workers 4 --max-phase-lag 1 --comm-dtype int8 --fragments 4

    # the smoke config on the CPU (plain attention and k-means, no kernels)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke

Backends ``vector``, ``barrier`` and ``service`` of ``repro.launch.train``
are ported; ``mesh`` waits for ROADMAP queue 1, item 3.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.dipaco import evaluate_routed, mean_nll
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
    ap.add_argument("--backend", default="vector",
                    choices=("vector", "barrier", "service"),
                    help="trainer backend (repro_torch.make_trainer); "
                         "'service'/'barrier' run the checkpointed "
                         "worker-pool infrastructure")
    ap.add_argument("--ckpt-root", default=None,
                    help="CheckpointDB root for service/barrier; a "
                         "temporary directory is created when omitted")
    ap.add_argument("--num-workers", type=int, default=4,
                    help="pool threads for --backend service/barrier")
    ap.add_argument("--max-phase-lag", type=int, default=1,
                    help="staleness window for --backend service")
    ap.add_argument("--fragments", type=int, default=1,
                    help="outer fragments K (streaming sync)")
    ap.add_argument("--comm-dtype", default="fp32",
                    choices=("fp32", "int8", "int4"))
    ap.add_argument("--comm-dtype-policy", default="uniform",
                    choices=("uniform", "leafwise"),
                    help="'leafwise' quantizes large matmul leaves hard "
                         "(int4) but keeps norms/embeddings in fp32")
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

    dcfg = DiPaCoConfig(levels=levels, inner_steps=args.tau,
                        outer_fragments=args.fragments,
                        comm_dtype=args.comm_dtype,
                        comm_dtype_policy=args.comm_dtype_policy)
    kw: dict = {}
    if args.backend != "vector":
        kw["ckpt_root"] = args.ckpt_root or tempfile.mkdtemp(
            prefix="dipaco-ckpt-")
        kw["num_workers"] = args.num_workers
        print(f"[launch] backend={args.backend} ckpt_root={kw['ckpt_root']}")
        if args.backend == "service":
            kw["max_phase_lag"] = args.max_phase_lag
    tr = make_trainer(cfg, dcfg, ds, backend=args.backend, device=device,
                      base_params=base, batch_size=args.batch_size,
                      peak_lr=2e-3, warmup=args.tau,
                      total_steps=args.phases * args.tau, **kw)
    t0 = time.time()
    losses = []
    try:
        for ph in range(args.phases):
            if args.backend == "service":
                loss = tr.run(1)["mean_loss"]     # pipelined, no barrier
            else:
                loss = tr.run_phase().mean_loss
            losses.append(loss)
            print(f"[phase {ph}] loss {loss:.4f} "
                  f"({time.time() - t0:.1f}s)")
        if args.backend == "service":
            print(f"[comm] {tr.comm_stats()}")
        va, _ = kmeans_assign(prefix_features(base, cfg, val), cents)
        res = evaluate_routed(
            lambda p, d: mean_nll(tr.path_params(p), cfg, d), val,
            va.cpu().numpy())
    finally:
        if args.backend != "vector":
            tr.shutdown()
    print(f"[eval] routed validation PPL {res['ppl']:.2f}")
    print("[done]")
    return {"phase_loss": losses, **res}


if __name__ == "__main__":
    main()
