"""Serving launcher of the port: routes batched requests to path replicas.

    # one-shot engine over randomly initialized paths, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dipaco-150m \
        --paths 4 --requests 8 --max-new 16 [--reroute-every 8]

    # the same on the CPU (plain versions, no kernels); --arch takes every
    # decoder the port declares (its smoke config): dipaco-dense-1b,
    # mamba2-1.3b, qwen2-moe-a2.7b, qwen3-8b, pixtral-12b (text only),
    # moonshot-v1-16b-a3b, jamba-v0.1-52b, gemma-2b, nemotron-4-340b,
    # qwen3-moe-235b-a22b; whisper-base (an encoder-decoder) runs
    # through repro_torch.models.api only
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

    # serve the promoted version of a deployment registry (written by a
    # Publisher, or by the JAX package), hot-swapping when the serving
    # pointer moves; --seed is the deployment's base-init seed
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --deploy-root /tmp/dipaco_deploy --levels 2x2 --swap-policy drain

    # a fleet of N engine processes behind the path-affinity front door
    # (requires --deploy-root: members rendezvous on the registry's
    # SERVING pointer, so one promote hot-swaps the whole fleet)
    PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 \
        --deploy-root /tmp/dipaco_deploy --levels 2x2
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig
from repro_torch.serving import (ContinuousBatchingEngine, EngineOptions,
                                 PathServingEngine, poisson_trace,
                                 prefix_hash_router)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dipaco-150m",
                    help="a decoder config the port declares (smoke "
                         "size); not whisper-base, an encoder-decoder")
    ap.add_argument("--engine", choices=["oneshot", "continuous"],
                    default="oneshot")
    ap.add_argument("--continuous", action="store_true",
                    help="deprecated alias for --engine continuous")
    ap.add_argument("--paths", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reroute-every", type=int, default=0)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="Poisson arrival rate (req/s), continuous engine")
    ap.add_argument("--slots", type=int, default=8,
                    help="cache slots per path island, continuous engine")
    ap.add_argument("--seed", type=int, default=0,
                    help="the random paths' seed; with --deploy-root the "
                         "deployment's base-init seed, which must match "
                         "the training run's")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda; it "
                         "raises where there is no card)")
    ap.add_argument("--deploy-root", default=None,
                    help="serve from the DeploymentRegistry at this root "
                         "(the promoted serving version) instead of "
                         "randomly initialized paths")
    ap.add_argument("--levels", default="2x2",
                    help="partition levels of the deployment (--deploy-"
                         "root), e.g. 2x2; must match the training run")
    ap.add_argument("--swap-policy", choices=["drain", "live"],
                    default="drain",
                    help="hot-swap pinning policy when the registry's "
                         "serving version moves mid-trace")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve through a fleet of N engines behind the "
                         "path-affinity front door (requires "
                         "--deploy-root)")
    ap.add_argument("--fleet-backend", choices=["process", "inproc"],
                    default="process",
                    help="fleet members as OS processes (default) or "
                         "in this process (debugging)")
    args = ap.parse_args(argv)
    engine_kind = "continuous" if args.continuous else args.engine
    if args.fleet and not args.deploy_root:
        ap.error("--fleet requires --deploy-root (fleet members "
                 "rendezvous on the registry's SERVING pointer)")
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch).replace(route_prefix_len=8)
    api.check_decoder(cfg)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=args.prompt_len, seed=0)
    prompts = corpus.sample_documents(args.requests)
    cache_len = args.prompt_len + args.max_new
    registry, paths = None, None
    if args.deploy_root:
        from repro_torch.deploy import DeploymentRegistry
        levels = tuple(int(x) for x in args.levels.split("x"))
        registry = DeploymentRegistry(
            cfg, DiPaCoConfig(levels=levels), args.deploy_root,
            seed=args.seed, device=device)
        num_paths = registry.num_paths
        print(f"[serve] registry {args.deploy_root}: versions "
              f"{registry.versions}, serving v{registry.serving_version}")
    else:
        num_paths = args.paths
        paths = [api.init_model(cfg, seed=args.seed * 1000 + p,
                                device=device)
                 for p in range(num_paths)]
    # one validated options bag configures either engine and the fleet
    opts = EngineOptions(registry=registry, swap_policy=args.swap_policy,
                         cache_len=cache_len, slots_per_path=args.slots,
                         reroute_every=args.reroute_every,
                         route_fn=prefix_hash_router(num_paths))
    trace = poisson_trace(args.requests, rate=args.rate,
                          prompt_lens=[args.prompt_len],
                          max_new=args.max_new, vocab_size=cfg.vocab_size,
                          seed=0, corpus=corpus)
    if args.fleet:
        from repro_torch.serving import ServingFleet
        t0 = time.time()
        with ServingFleet(cfg, size=args.fleet, options=opts,
                          backend=args.fleet_backend,
                          seed=args.seed) as fleet:
            fins = fleet.serve_trace(trace)
            versions = fleet.versions()
            stats = dict(fleet.stats)
        dt = time.time() - t0
        toks = args.requests * args.max_new
        lat = sorted(f.latency for f in fins)
        print(f"[serve] fleet of {args.fleet} ({args.fleet_backend}) on "
              f"{device}: {toks} tokens in {dt:.2f}s ({toks / dt:.1f} "
              f"tok/s), p50 latency {lat[len(lat) // 2] * 1e3:.0f}ms, "
              f"routed={stats['routed']} "
              f"rebalances={stats['rebalances']}")
        print(f"[serve] member versions {versions}")
        print(f"[serve] request->path: {[f.path for f in fins]}")
        return
    if engine_kind == "continuous":
        engine = ContinuousBatchingEngine(cfg, paths, options=opts)
        engine.warmup()
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
        if registry is not None:
            print(f"[serve] served version(s) "
                  f"{sorted(set(f.version for f in fins))}, "
                  f"hot swaps={engine.swaps}")
        print(f"[serve] request->path: "
              f"{[f.path for f in sorted(fins, key=lambda f: f.rid)]}")
        return
    engine = PathServingEngine(cfg, paths, options=EngineOptions(
        registry=registry, cache_len=cache_len))
    t0 = time.time()
    res = engine.generate(prompts, max_new=args.max_new,
                          reroute_every=args.reroute_every)
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(f"[serve] {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {device}, switches={res.switches}")
    if registry is not None:
        print(f"[serve] serving version v{engine.version}")
    print(f"[serve] request->path: {res.paths.tolist()}")


if __name__ == "__main__":
    main()
