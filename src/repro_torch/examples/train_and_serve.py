"""Train and serve concurrently in one process: the live deployment
plane end to end (paper §2.4/§3: training is an always-on service;
serving tracks it without restarts); the port of
``examples/train_and_serve.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_and_serve \
        [--device cpu]          # PHASES=<n> sets the training phases

Wiring:

 * a ``TrainingService`` advances asynchronous outer phases on a
   background pool, writing per-module checkpoint rows;
 * a ``Publisher`` (daemon thread, woken by the checkpoint DB's
   listener API) cuts a candidate manifest when an outer phase
   completes, canary-gates it on a held-out shadow trace, and promotes
   it in the ``DeploymentRegistry``;
 * a ``ContinuousBatchingEngine`` serves a Poisson request trace on the
   main thread, hot-swapping to each promoted version between decode
   ticks (drain policy: every request finishes on the version it was
   admitted under).

At the end the registry is rolled back one version and the engine
swaps back, the same path operators take when a bad version slips
through the gate.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import threading
import time

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticCorpus, shard_documents
from repro_torch.deploy import CanaryGate, DeploymentRegistry, Publisher
from repro_torch.examples import add_device_flag, on_device
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig
from repro_torch.serving import (ContinuousBatchingEngine, EngineOptions,
                                 poisson_trace, prefix_hash_router)


def run(*, device="cuda", phases: int = 3, docs: int = 256,
        trace_requests: int = 64, tmp_dir: str | None = None) -> dict:
    """The script's body; the defaults are its sizes.  Everything it
    writes lives in a temporary directory under ``tmp_dir`` (default:
    the temporary directory), removed at the end."""
    dev, cfg = on_device(
        get_smoke_config("dipaco-150m").replace(route_prefix_len=8), device)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=4)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=48, seed=0)
    tokens, doms = corpus.sample_documents(docs, return_domains=True)
    ds = shard_documents(tokens, doms % 4, 4)
    base = api.init_model(cfg, seed=0, device=dev)
    num_paths = 4

    with tempfile.TemporaryDirectory(dir=tmp_dir) as root:
        print("== training service (async phase pipelining)")
        svc = repro_torch.make_trainer(cfg, dcfg, ds, backend="service",
                                       seed=0, device=dev,
                                       ckpt_root=os.path.join(root, "db"),
                                       base_params=base, batch_size=8,
                                       peak_lr=2e-3, warmup=10,
                                       total_steps=200, num_workers=2,
                                       max_phase_lag=1)
        pub = None
        try:
            print("== deployment registry + canary-gated publisher")
            registry = DeploymentRegistry(cfg, dcfg,
                                          os.path.join(root, "deploy"),
                                          seed=0, base_params=base,
                                          device=dev)
            shadow = corpus.sample_documents(16, seed=99)[:, :32]
            gate = CanaryGate(cfg, shadow, ppl_ratio_tol=1.5,
                              min_agreement=0.0)
            pub = Publisher(svc.db, registry, gate=gate)
            pub.bootstrap()                  # v1 = base initialization
            pub.start(period=0.2)            # woken by module-row writes

            print("== engine serving from the registry (drain hot-swap)")
            engine = ContinuousBatchingEngine(cfg, options=EngineOptions(
                registry=registry, cache_len=48, slots_per_path=2,
                swap_policy="drain",
                route_fn=prefix_hash_router(num_paths)))
            engine.warmup()

            failed = []

            def train():
                try:
                    svc.run(phases, tau=dcfg.inner_steps)
                except Exception as e:  # noqa: BLE001 - raised after join
                    failed.append(e)

            trainer = threading.Thread(target=train, daemon=True)
            t0 = time.time()
            trainer.start()

            trace = poisson_trace(trace_requests, rate=8.0, prompt_lens=[16],
                                  max_new=12, vocab_size=cfg.vocab_size,
                                  seed=3, corpus=corpus)
            fins = []
            i = 0
            while trainer.is_alive() or i < len(trace) or not engine.idle:
                now = time.time() - t0
                while i < len(trace) and trace[i].arrival <= now:
                    engine.submit(trace[i])
                    i += 1
                if engine.idle:
                    time.sleep(0.01)
                    continue
                fins.extend(engine.step(now=now))
            trainer.join()
            if failed:
                raise RuntimeError("the training service failed") \
                    from failed[0]
            # drain the publisher's last cycle, then let the engine swap
            pub.publish_cycle()
            fins.extend(engine.serve_trace(
                poisson_trace(8, rate=50.0, prompt_lens=[16], max_new=12,
                              vocab_size=cfg.vocab_size, seed=4,
                              corpus=corpus)))

            by_version: dict = {}
            for f in fins:
                by_version[f.version] = by_version.get(f.version, 0) + 1
            lat = sorted(f.latency for f in fins)
            ttft = sorted(f.ttft for f in fins)
            print(f"== served {len(fins)} requests over versions "
                  f"{dict(sorted(by_version.items()))} "
                  f"({engine.swaps} hot swaps)")
            print(f"   p50 latency {lat[len(lat) // 2] * 1e3:.0f}ms, "
                  f"p50 ttft {ttft[len(ttft) // 2] * 1e3:.0f}ms")
            print(f"   publisher: published={pub.published} "
                  f"rejected={pub.rejected} rollbacks={pub.rollbacks}; "
                  f"registry versions {registry.versions}, "
                  f"serving v{registry.serving_version}")
            swaps = engine.swaps
            latest = registry.serving_version

            print("== operator rollback")
            prev = registry.rollback()
            fins2 = engine.serve_trace(poisson_trace(
                4, rate=50.0, prompt_lens=[16], max_new=8,
                vocab_size=cfg.vocab_size, seed=5, corpus=corpus))
            versions2 = sorted(set(f.version for f in fins2))
            print(f"   serving v{registry.serving_version} (rolled back to "
                  f"{prev}); new requests finished on {versions2}")
        finally:
            if pub is not None:
                pub.close()
            svc.shutdown()
    return {"cfg": cfg, "finished": fins, "by_version": by_version,
            "swaps": swaps, "swaps_after_rollback": engine.swaps,
            "latest": latest, "rolled_back_to": prev,
            "versions_after_rollback": versions2,
            "published": pub.published}


def parser() -> argparse.ArgumentParser:
    """The script's flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    return run(device=args.device,
               phases=int(os.environ.get("PHASES", "3")))


if __name__ == "__main__":
    main()
