"""Round-based DiPaCo training on the §3 infrastructure — a thin
synchronous wrapper over the asynchronous ``TrainingService``; the port
of ``repro/infra/trainer.py``.

Workflow (paper Figure 6):
 1. each phase enqueues one train task per path/shard,
 2. pool workers fetch tasks, assemble their path from the module store,
    run tau inner AdamW steps on their shard, write a delta checkpoint
    to the DB,
 3. sharded outer executors consume checkpoints online and apply the
    per-module Nesterov update the moment the last contributor lands,
 4. the next phase starts; preempted workers' tasks are re-leased and
    dead worker threads are restarted by the service's Monitor.

``run_phase`` is exactly ``TrainingService`` with ``max_phase_lag=0``:
the staleness window degenerates to a global barrier, so the trainer
stays mathematically identical to core/dipaco.DiPaCoTrainer when every
task succeeds on first attempt (asserted in tests, up to the order of
the f32 sums) and robust to preemptions because tasks are idempotent.  The pipelined, barrier-free
regime lives in infra/service.py.
"""
from __future__ import annotations

from repro_torch.data.sharder import PreShardedDataset
from repro_torch.models.config import DiPaCoConfig, ModelConfig
from .service import PhaseTimeoutError, TrainingService

__all__ = ["InfraDiPaCoTrainer", "PhaseTimeoutError"]


class InfraDiPaCoTrainer:
    def __init__(self, cfg: ModelConfig, dcfg: DiPaCoConfig,
                 dataset: PreShardedDataset, *, ckpt_root: str,
                 base_params=None, batch_size: int = 8,
                 peak_lr: float = 4e-4, warmup: int = 100,
                 total_steps: int = 10_000, num_workers: int = 4,
                 preempt_prob: float = 0.0, seed: int = 0, device="cuda",
                 **service_kw):
        self.service = TrainingService(
            cfg, dcfg, dataset, ckpt_root=ckpt_root, device=device,
            base_params=base_params, batch_size=batch_size,
            peak_lr=peak_lr, warmup=warmup, total_steps=total_steps,
            num_workers=num_workers, preempt_prob=preempt_prob,
            seed=seed, max_phase_lag=0, **service_kw)

    # -- legacy surface -------------------------------------------------
    @property
    def cfg(self):
        return self.service.cfg

    @property
    def dcfg(self):
        return self.service.dcfg

    @property
    def partition(self):
        return self.service.partition

    @property
    def store(self):
        return self.service.store

    @property
    def execs(self):
        return self.service.execs

    @property
    def db(self):
        return self.service.db

    @property
    def losses(self):
        return self.service.losses

    @property
    def worker_paths(self):
        return self.service.worker_paths

    @property
    def num_shards(self):
        return self.service.num_shards

    @property
    def phase(self):
        return self.service.phase

    @property
    def step(self):
        return self.service.step

    @classmethod
    def resume(cls, cfg, dcfg, dataset, *, ckpt_root, **kw):
        """Reconstruct a killed barrier trainer from its checkpoint
        root — ``TrainingService.resume`` pinned to ``max_phase_lag=0``
        (the ``Trainer`` protocol's resume signature)."""
        self = cls.__new__(cls)
        self.service = TrainingService.resume(
            cfg, dcfg, dataset, ckpt_root=ckpt_root, max_phase_lag=0, **kw)
        return self

    def run_phase(self, tau: int | None = None, *,
                  sample_paths: int | None = None,
                  seed: int | None = None):
        return self.service.run_phase(tau, sample_paths=sample_paths,
                                      seed=seed)

    def path_params(self, path_id: int):
        return self.service.path_params(path_id)

    def shutdown(self):
        self.service.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
