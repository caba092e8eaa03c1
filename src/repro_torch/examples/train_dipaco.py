"""End-to-end DiPaCo training driver; the port of
``examples/train_dipaco.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_dipaco --preset mini
    PYTHONPATH=src python -m repro_torch.examples.train_dipaco \
        --preset paper --phases 2      # the full 150M path model

Presets:
  mini   reduced 2-layer path (CPU-friendly), 4 paths, a few hundred
         total inner steps.
  paper  the paper's exact 150M path config (12L d896 h16); one phase of
         tau=100 is a few hundred optimizer steps.

Runs: discriminative re-sharding once mid-training (Algorithm 1 line 2),
early stopping, a worker-stacked checkpoint dump each phase.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.routing import (kmeans_assign, kmeans_fit,
                                      prefix_features, score_documents,
                                      train_discriminative_router)
from repro_torch.data import ShardLoader, SyntheticCorpus, shard_documents
from repro_torch.examples import add_device_flag, generator, on_device
from repro_torch.infra.ckpt_db import CheckpointDB, load_tree
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig
from repro_torch.training import make_trainer

HOLDOUT_FRAC = 0.05


def preset(name: str, tau=None, batch_size=None) -> tuple:
    """-> (cfg, seq_len, batch size, tau) of a preset."""
    if name == "paper":
        return get_config("dipaco-150m"), 256, batch_size or 8, tau or 100
    if name == "mini":
        return (get_smoke_config("dipaco-150m").replace(route_prefix_len=8),
                64, batch_size or 8, tau or 25)
    raise ValueError(f"preset {name!r} not in ('mini', 'paper')")


def swap_shards(tr, docs, assign, num_shards: int, batch_size: int):
    """Re-shard ``docs`` by ``assign`` and hand the trainer the new
    shards and their loaders.  A shard left empty raises ``ValueError``
    (``ShardLoader``; the reference's loader asserts), before the
    trainer is touched."""
    new_ds = shard_documents(docs, assign, num_shards,
                             holdout_frac=HOLDOUT_FRAC)
    print(f"[reshard] new shard sizes: {new_ds.sizes.tolist()}")
    loaders = [ShardLoader(s, batch_size, seed=100 + i)
               for i, s in enumerate(new_ds.shards)]
    tr.dataset, tr.loaders = new_ds, loaders
    return new_ds


def restore_dump(db: CheckpointDB, like):
    """The last full dump in ``db``, read back like ``like`` (the
    trainer's worker-stacked parameters) onto its devices."""
    rows = db.rows(kind="full")
    if not rows:
        raise ValueError(f"no full dump in {db.root}")
    return load_tree(rows[-1].file, like)


def run(*, preset_name: str = "mini", levels: str = "2x2", phases: int = 4,
        tau=None, batch_size=None, docs: int = 2048, ckpt: str | None = None,
        device="cuda", base_params=None, kmeans_init=None,
        router_init_w=None, on_phase=None) -> dict:
    """The script's body; the defaults are its flags' defaults.
    ``base_params``, ``kmeans_init`` (k-means seeds) and
    ``router_init_w`` (the router's initial weights) replace the seeded
    draws; ``on_phase(ph, trainer)`` runs after each phase's dump, before
    the re-shard."""
    cfg, seq, bs, tau = preset(preset_name, tau, batch_size)
    dev, cfg = on_device(cfg, device)
    ckpt = ckpt or os.path.join(tempfile.gettempdir(), "dipaco_ckpts")
    lv = tuple(int(x) for x in levels.split("x"))
    P = int(np.prod(lv))

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size,
                             num_domains=max(8, P), seq_len=seq, seed=0)
    tokens, _ = corpus.sample_documents(docs, return_domains=True)
    rdocs = corpus.sample_documents(256, seed=7)
    val = corpus.sample_documents(256, seed=99)
    t0 = time.time()
    print(f"[init] {cfg.name}: initializing base model")
    base = (base_params if base_params is not None
            else api.init_model(cfg, seed=0, device=dev))

    print(f"[route] k-means coarse routing into {P} shards (§2.4.1)")
    feats = prefix_features(base, cfg, tokens)
    cents, assign, _ = kmeans_fit(feats, P, generator=generator(dev, 1),
                                  init=kmeans_init)
    ds = shard_documents(tokens, assign.cpu().numpy(), P,
                         holdout_frac=HOLDOUT_FRAC)
    out = {"cfg": cfg, "base": base, "docs": tokens, "feats": feats,
           "router_docs": rdocs, "val": val, "centroids": cents,
           "dataset": ds,
           "sizes_before": ds.sizes.tolist(), "sizes_after": None,
           "phases": [], "ckpt": ckpt}
    print(f"[route] shard sizes: {out['sizes_before']}")

    dcfg = DiPaCoConfig(levels=lv, inner_steps=tau, early_stopping=True)
    # unified factory: backend="vector" is the in-memory Algorithm 1
    # trainer; "mesh" would run the same phases through real collectives
    tr = make_trainer(cfg, dcfg, ds, backend="vector", seed=0, device=dev,
                      base_params=base, batch_size=bs, peak_lr=2e-3,
                      warmup=tau, total_steps=phases * tau)
    db = CheckpointDB(ckpt)
    out.update(trainer=tr, db=db)

    for ph in range(phases):
        m = tr.run_phase()
        out["phases"].append({"mean_loss": m.mean_loss,
                              "final_loss": m.final_loss,
                              "best_holdout": tr.best_holdout.copy()})
        print(f"[phase {ph}] mean loss {m.mean_loss:.4f} "
              f"final {m.final_loss:.4f} ({time.time() - t0:.0f}s)")
        # full worker-stacked dump ("module" names the executors'
        # per-module recovery checkpoints, see infra/ckpt_db.py)
        db.write(tr.worker_params, path_id=-1, phase=ph, step=tr.step,
                 kind="full")
        if on_phase is not None:
            on_phase(ph, tr)
        if ph == phases // 2 - 1 and P > 1:
            # discriminative re-sharding once during training (Alg. 1 l.2)
            print("[reshard] discriminative EM step (§2.4.2)")
            paths = [tr.path_params(p) for p in range(P)]
            scores = score_documents(paths, cfg, rdocs)
            targets = scores.argmax(dim=1)
            rfeats = prefix_features(base, cfg, rdocs)
            router = train_discriminative_router(
                rfeats, targets, P, steps=300,
                generator=generator(dev, 2), init_w=router_init_w)
            new_ds = swap_shards(tr, tokens, router.assign(feats).cpu()
                                 .numpy(), P, bs)
            out.update(scores=scores, router=router, reshard_phase=ph,
                       sizes_after=new_ds.sizes.tolist())

    print("[eval] routed validation")
    va, _ = kmeans_assign(prefix_features(base, cfg, val), cents)
    va = va.cpu().numpy()
    res = tr.evaluate_routed(val, va, best=True)
    out.update(eval=res, val_assign=va)
    print(f"[done] val ppl {res['ppl']:.2f}  wall {time.time() - t0:.0f}s  "
          f"checkpoints in {ckpt}")
    return out


def parser() -> argparse.ArgumentParser:
    """The script's flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=["mini", "paper"], default="mini")
    ap.add_argument("--levels", default="2x2")
    ap.add_argument("--phases", type=int, default=4)
    ap.add_argument("--tau", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint root (default: dipaco_ckpts in the "
                         "temporary directory)")
    add_device_flag(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    return run(preset_name=args.preset, levels=args.levels,
               phases=args.phases, tau=args.tau, batch_size=args.batch_size,
               docs=args.docs, ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
