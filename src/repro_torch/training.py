"""Trainer factory of the port: ``make_trainer`` over the backends of
``repro/training.py``.

    tr = repro_torch.make_trainer(cfg, dcfg, dataset, backend="vector",
                                  seed=0, device="cuda", batch_size=8)
    m = tr.run_phase()

Only ``"vector"`` (``core.dipaco.DiPaCoTrainer``, the in-memory
stacked-worker simulation of Algorithm 1) is ported.  ``"barrier"``,
``"service"`` and ``"mesh"`` need the checkpoint plane and multi-process
training (ROADMAP queue 1, item 3) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.core.dipaco import DiPaCoTrainer, PhaseMetrics

BACKENDS = ("vector", "barrier", "service", "mesh")

__all__ = ["BACKENDS", "PhaseMetrics", "make_trainer"]


def make_trainer(cfg, dcfg, dataset, *, backend: str = "vector",
                 seed: int = 0, device="cuda", ckpt_root: str | None = None,
                 resume: bool = False, **kw) -> DiPaCoTrainer:
    """Construct a trainer backend.  Remaining kwargs go to the backend's
    constructor (base_params, batch_size, peak_lr, warmup, total_steps).
    Parameters are made on ``device`` (default ``"cuda"``; it raises
    where there is no card) unless ``base_params`` are given."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend != "vector":
        raise NotImplementedError(
            f"backend {backend!r} is not ported to repro_torch yet: it needs "
            f"the checkpoint plane and multi-process training (ROADMAP "
            f"queue 1, item 3); use backend='vector'")
    if ckpt_root is not None:
        raise ValueError("backend='vector' is in-memory only and takes no "
                         "ckpt_root")
    if resume:
        return DiPaCoTrainer.resume(cfg, dcfg, dataset)   # raises, on purpose
    return DiPaCoTrainer(cfg, dcfg, dataset, seed=seed, device=device, **kw)
