"""Serving launcher of the port: routes batched requests to path replicas.

    # one-shot engine over randomly initialized paths, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dipaco-150m \
        --paths 4 --requests 8 --max-new 16 [--reroute-every 8]

    # the same on the CPU (plain versions, no kernels); --arch also takes
    # mamba2-1.3b and qwen2-moe-a2.7b (their smoke configs)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-1.3b

    # the continuous-batching engine fed by a Poisson trace, routed by a
    # prompt hash over the islands (the dense tick is captured in a CUDA
    # graph on the card)
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --rate 40 [--slots 8]
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --engine continuous

The deployment registry (``--deploy-root``, hot swaps) and the serving
fleet are not ported yet (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import (ContinuousBatchingEngine, EngineOptions,
                                 PathServingEngine, poisson_trace,
                                 prefix_hash_router)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dipaco-150m",
                    help="a config the port declares (smoke size): "
                         "dipaco-150m, mamba2-1.3b, qwen2-moe-a2.7b")
    ap.add_argument("--engine", choices=["oneshot", "continuous"],
                    default="oneshot")
    ap.add_argument("--paths", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reroute-every", type=int, default=0)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="Poisson arrival rate (req/s), continuous engine")
    ap.add_argument("--slots", type=int, default=8,
                    help="cache slots per path island, continuous engine")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda; it "
                         "raises where there is no card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch).replace(route_prefix_len=8)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=args.prompt_len, seed=0)
    prompts = corpus.sample_documents(args.requests)
    cache_len = args.prompt_len + args.max_new
    paths = [api.init_model(cfg, seed=args.seed * 1000 + p, device=device)
             for p in range(args.paths)]
    if args.engine == "continuous":
        opts = EngineOptions(cache_len=cache_len, slots_per_path=args.slots,
                             reroute_every=args.reroute_every,
                             route_fn=prefix_hash_router(args.paths))
        engine = ContinuousBatchingEngine(cfg, paths, options=opts)
        engine.warmup()
        trace = poisson_trace(args.requests, rate=args.rate,
                              prompt_lens=[args.prompt_len],
                              max_new=args.max_new,
                              vocab_size=cfg.vocab_size, seed=0,
                              corpus=corpus)
        t0 = time.time()
        fins = engine.serve_trace(trace, realtime=True)
        dt = time.time() - t0
        toks = args.requests * args.max_new
        lat = sorted(f.latency for f in fins)
        ttft = sorted(f.ttft for f in fins)
        print(f"[serve] {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s) "
              f"on {device} over {engine.ticks} ticks, "
              f"p50 latency {lat[len(lat) // 2] * 1e3:.0f}ms, "
              f"p50 ttft {ttft[len(ttft) // 2] * 1e3:.0f}ms, "
              f"switches={sum(f.switches for f in fins)}, "
              f"cuda graph={engine._graph is not None}")
        print(f"[serve] request->path: "
              f"{[f.path for f in sorted(fins, key=lambda f: f.rid)]}")
        return
    engine = PathServingEngine(cfg, paths,
                               options=EngineOptions(cache_len=cache_len))
    t0 = time.time()
    res = engine.generate(prompts, max_new=args.max_new,
                          reroute_every=args.reroute_every)
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(f"[serve] {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {device}, switches={res.switches}")
    print(f"[serve] request->path: {res.paths.tolist()}")


if __name__ == "__main__":
    main()
