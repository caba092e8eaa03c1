"""Quickstart: train a 2x2 DiPaCo on a synthetic multi-domain corpus.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the whole pipeline: corpus -> prefix features -> k-means coarse
routing -> offline pre-sharding -> DiLoCo-per-module training ->
routed evaluation.  The port of ``examples/quickstart.py``.
"""
from __future__ import annotations

import argparse

import numpy as np

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core.routing import kmeans_assign, kmeans_fit, \
    prefix_features
from repro_torch.data import SyntheticCorpus, shard_documents
from repro_torch.examples import add_device_flag, generator, on_device
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig


def run(*, device="cuda", docs: int = 1024, val_docs: int = 128,
        phases: int = 4, tau: int = 20) -> dict:
    """The script's body; the defaults are its sizes."""
    dev, cfg = on_device(
        get_smoke_config("dipaco-150m").replace(route_prefix_len=8), device)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=64, seed=0)
    tokens, _ = corpus.sample_documents(docs, return_domains=True)
    val, _ = corpus.sample_documents(val_docs, seed=99, return_domains=True)
    base = api.init_model(cfg, seed=0, device=dev)

    print("== 1. coarse routing (paper §2.4): k-means on prefix features")
    feats = prefix_features(base, cfg, tokens)
    cents, assign, _ = kmeans_fit(feats, 4, generator=generator(dev, 1))
    assign = assign.cpu().numpy()
    print(f"   shard sizes: {np.bincount(assign, minlength=4)}")

    print("== 2. offline pre-sharding (one shard per path)")
    ds = shard_documents(tokens, assign, 4, holdout_frac=0.05)

    print(f"== 3. DiPaCo 2x2 training (Algorithm 1, tau={tau})")
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=tau)
    # backend="vector" is the in-memory Algorithm 1 trainer; swap in
    # "service" (async infra) or "mesh" (real collectives) unchanged
    tr = repro_torch.make_trainer(cfg, dcfg, ds, backend="vector", seed=0,
                                  device=dev, base_params=base, batch_size=8,
                                  peak_lr=3e-3, warmup=10, total_steps=400)
    losses = []
    for ph in range(phases):
        m = tr.run_phase()
        losses.append(m.mean_loss)
        print(f"   phase {ph}: mean loss {m.mean_loss:.3f} "
              f"(outer sync: 1 communication round)")

    print("== 4. routed evaluation (route once per sequence)")
    va, _ = kmeans_assign(prefix_features(base, cfg, val), cents)
    res = tr.evaluate_routed(val, va.cpu().numpy())
    print(f"   validation PPL: {res['ppl']:.2f} "
          f"(oracle entropy PPL: {np.exp(corpus.oracle_nll()):.2f})")
    return {"cfg": cfg, "trainer": tr, "shard_sizes": ds.sizes.tolist(),
            "losses": losses, "eval": res}


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
