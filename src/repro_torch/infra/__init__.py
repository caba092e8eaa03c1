"""The §3 training infrastructure of the port (``repro/infra`` in the
reference): task queue and worker pool, checkpoint DB, sharded outer
executors, transports, fleet controller and the training service."""
from .task_queue import Task, TaskQueue
from .ckpt_db import CheckpointDB
from .worker_pool import Monitor, WorkerPool
from .outer_executor import ShardedOuterExecutors
from .transport import (FaultInjector, InProcessTransport, MeshTransport,
                        RetryingTransport, RetryPolicy, TransportError,
                        make_transport)
from .fleet import ChaosController, FleetController, WorkerProfile
from .service import PhaseTimeoutError, TrainingService
from .trainer import InfraDiPaCoTrainer

__all__ = ["Task", "TaskQueue", "CheckpointDB", "Monitor", "WorkerPool",
           "ShardedOuterExecutors", "FaultInjector", "InProcessTransport",
           "MeshTransport", "RetryingTransport",
           "RetryPolicy", "TransportError", "make_transport",
           "ChaosController", "FleetController", "WorkerProfile",
           "PhaseTimeoutError", "TrainingService", "InfraDiPaCoTrainer"]
