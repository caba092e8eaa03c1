"""Serve trained paths with batched requests, eval-time re-routing
(paper §2.4.3 / Fig. 3), and a continuous-batching engine absorbing a
Poisson arrival trace; the port of ``examples/serve_paths.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_paths [--device cpu]
"""
from __future__ import annotations

import argparse

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core.routing import (prefix_features, score_documents,
                                      train_discriminative_router)
from repro_torch.data import SyntheticCorpus, shard_documents
from repro_torch.examples import add_device_flag, generator, on_device
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig
from repro_torch.serving import (ContinuousBatchingEngine, EngineOptions,
                                 PathServingEngine, poisson_trace)


def run(*, device="cuda", docs: int = 1024, phases: int = 3, tau: int = 20,
        router_docs: int = 128, router_steps: int = 200,
        requests: int = 8, trace_requests: int = 16) -> dict:
    """The script's body; the defaults are its sizes."""
    dev, cfg = on_device(
        get_smoke_config("dipaco-150m").replace(route_prefix_len=8), device)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=64, seed=0)
    tokens, doms = corpus.sample_documents(docs, return_domains=True)
    base = api.init_model(cfg, seed=0, device=dev)

    print("== train 4 paths quickly (oracle domain shards)")
    ds = shard_documents(tokens, doms % 4, 4)
    tr = repro_torch.make_trainer(cfg, DiPaCoConfig(levels=(2, 2),
                                                    inner_steps=tau),
                                  ds, backend="vector", seed=0, device=dev,
                                  base_params=base, batch_size=8,
                                  peak_lr=3e-3, warmup=10, total_steps=200)
    for _ in range(phases):
        tr.run_phase()
    paths = [tr.path_params(p) for p in range(4)]

    print("== fit a discriminative router on path scores (§2.4.2)")
    rdocs = corpus.sample_documents(router_docs, seed=7)
    scores = score_documents(paths, cfg, rdocs)
    rfeats = prefix_features(base, cfg, rdocs)
    router = train_discriminative_router(
        rfeats, scores.argmax(dim=1), 4, steps=router_steps,
        generator=generator(dev, 2))

    print("== serve a batch of requests")
    engine = PathServingEngine(cfg, paths, options=EngineOptions(
        router=router, feat_params=base, cache_len=96))
    prompts, pdoms = corpus.sample_documents(requests, seed=123,
                                             return_domains=True)
    res = engine.generate(prompts[:, :16], max_new=16)
    print(f"   routed to paths: {res.paths.tolist()} (domains "
          f"{pdoms.tolist()})")
    print(f"   first continuation: {res.tokens[0, 16:].tolist()}")

    print("== re-route every 8 tokens during decode (§2.4.3)")
    res2 = engine.generate(prompts[:, :16], max_new=16, reroute_every=8)
    print(f"   path switches during generation: {res2.switches}")

    print("== continuous batching: Poisson arrivals into slot arenas")
    cont = ContinuousBatchingEngine(cfg, paths, options=EngineOptions(
        router=router, feat_params=base, cache_len=96,
        slots_per_path=4, reroute_every=8))
    cont.warmup()   # pre-build the bounded (bucket, batch) set
    trace = poisson_trace(trace_requests, rate=40.0,
                          prompt_lens=(12, 16, 24), max_new=16,
                          vocab_size=cfg.vocab_size, seed=11, corpus=corpus)
    fins = cont.serve_trace(trace, realtime=True)
    lat = sorted(f.latency for f in fins)
    stats = cont.scheduler.stats
    print(f"   served {len(fins)} requests in {cont.ticks} ticks "
          f"(p50 latency {lat[len(lat) // 2] * 1e3:.0f}ms, "
          f"switches {sum(f.switches for f in fins)})")
    print(f"   admitted={stats.admitted} completed={stats.completed} "
          f"backpressure_ticks={stats.backpressure_ticks}")
    return {"cfg": cfg, "generate": res, "rerouted": res2,
            "finished": fins, "stats": stats}


def parser() -> argparse.ArgumentParser:
    """The script's flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
