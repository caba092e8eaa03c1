"""Trainer factory of the port: one protocol, one factory, the four
backends of ``repro/training.py``.

Every backend exposes the same surface (``Trainer``):

 * ``run_phase(tau=None, ...) -> PhaseMetrics``
 * ``path_params(path_id)``
 * ``resume(cfg, dcfg, dataset, *, ckpt_root, **kw)`` classmethod

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
``"mesh"``     launch.train.MeshStreamingTrainer — the streaming
               fragment schedule with each fragment's reduce gathered
               across the ranks of a ``torch.distributed`` worker mesh
               (a world of one where no process group exists), overlapped
               with inner compute; phase-state-file resume.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core.dipaco import DiPaCoTrainer, PhaseMetrics

BACKENDS = ("vector", "barrier", "service", "mesh")

__all__ = ["BACKENDS", "PhaseMetrics", "Trainer", "make_trainer",
           "trainer_class"]


@runtime_checkable
class Trainer(Protocol):
    """The surface all four backends share."""

    def run_phase(self, tau=None, **kw) -> PhaseMetrics:
        ...

    def path_params(self, path_id: int):
        ...

    @classmethod
    def resume(cls, cfg, dcfg, dataset, *, ckpt_root, **kw):
        ...


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
        from repro_torch.launch.train import MeshStreamingTrainer
        return MeshStreamingTrainer
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def make_trainer(cfg, dcfg, dataset, *, backend: str = "vector",
                 seed: int = 0, device="cuda", ckpt_root: str | None = None,
                 resume: bool = False, **kw):
    """Construct (or resume) a trainer backend.

    ``ckpt_root`` is required for the DB-backed backends ("barrier",
    "service") and for resuming "mesh", optional for "mesh" (enables
    phase checkpointing) and rejected for "vector".  Remaining kwargs go
    to the backend's constructor (base_params, batch_size, peak_lr,
    warmup, total_steps, and backend-specific ones like num_workers /
    max_phase_lag / mesh).  Parameters are made on, or moved to, ``device``
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
    if backend == "mesh" and not resume:
        return cls(cfg, dcfg, dataset, seed=seed, device=device,
                   ckpt_root=ckpt_root, **kw)
    if ckpt_root is None:
        raise ValueError(f"backend={backend!r} persists to a CheckpointDB "
                         "or resumes from one: pass ckpt_root=")
    if resume:
        return cls.resume(cfg, dcfg, dataset, seed=seed, device=device,
                          ckpt_root=ckpt_root, **kw)
    return cls(cfg, dcfg, dataset, seed=seed, device=device,
               ckpt_root=ckpt_root, **kw)
