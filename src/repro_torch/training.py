"""Trainer factory of the port: ``make_trainer`` over the backends of
``repro/training.py``.

    tr = repro_torch.make_trainer(cfg, dcfg, dataset, backend="vector",
                                  seed=0, device="cuda", batch_size=8)
    m = tr.run_phase()

Backends:

``"vector"``   core.dipaco.DiPaCoTrainer — in-memory stacked-worker
               simulation (Algorithm 1); no durable state.
``"barrier"``  infra.trainer.InfraDiPaCoTrainer — the round-based §3
               infrastructure pinned to a global barrier
               (max_phase_lag=0); CheckpointDB resume.
``"service"``  infra.service.TrainingService — asynchronous
               phase-pipelined service with staleness window, fragment
               streaming and delta transports; CheckpointDB resume.

``"mesh"`` needs multi-process training on ``torch.distributed``
(ROADMAP queue 1, item 3) and raises ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.core.dipaco import DiPaCoTrainer, PhaseMetrics

BACKENDS = ("vector", "barrier", "service", "mesh")

__all__ = ["BACKENDS", "PhaseMetrics", "make_trainer", "trainer_class"]


def trainer_class(backend: str):
    if backend == "vector":
        return DiPaCoTrainer
    if backend == "barrier":
        from repro_torch.infra.trainer import InfraDiPaCoTrainer
        return InfraDiPaCoTrainer
    if backend == "service":
        from repro_torch.infra.service import TrainingService
        return TrainingService
    if backend == "mesh":
        raise NotImplementedError(
            "backend 'mesh' is not ported to repro_torch yet: it needs "
            "multi-process training on torch.distributed (ROADMAP queue 1, "
            "item 3); use backend='vector', 'barrier' or 'service'")
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def make_trainer(cfg, dcfg, dataset, *, backend: str = "vector",
                 seed: int = 0, device="cuda", ckpt_root: str | None = None,
                 resume: bool = False, **kw):
    """Construct (or resume) a trainer backend.

    ``ckpt_root`` is required for the DB-backed backends ("barrier",
    "service") and rejected for "vector".  Remaining kwargs go to the
    backend's constructor (base_params, batch_size, peak_lr, warmup,
    total_steps, and backend-specific ones like num_workers /
    max_phase_lag).  Parameters are made on, or moved to, ``device``
    (default ``"cuda"``; it raises where there is no card); the vector
    backend keeps given ``base_params`` on their own device.
    """
    cls = trainer_class(backend)
    if backend == "vector":
        if ckpt_root is not None:
            raise ValueError("backend='vector' is in-memory only and takes "
                             "no ckpt_root")
        if resume:
            return cls.resume(cfg, dcfg, dataset)    # raises, on purpose
        return cls(cfg, dcfg, dataset, seed=seed, device=device, **kw)
    if ckpt_root is None:
        raise ValueError(f"backend={backend!r} persists to a CheckpointDB: "
                         "pass ckpt_root=")
    if resume:
        return cls.resume(cfg, dcfg, dataset, seed=seed, device=device,
                          ckpt_root=ckpt_root, **kw)
    return cls(cfg, dcfg, dataset, seed=seed, device=device,
               ckpt_root=ckpt_root, **kw)
