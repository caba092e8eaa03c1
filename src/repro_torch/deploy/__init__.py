"""Live deployment plane: stream module checkpoints from the training
service into serving engines with atomic hot-swap, canary gating and
rollback (paper §2.4/§3: training is an always-on service; serving must
track it without restarts); the port of ``repro/deploy``."""
from .canary import CanaryGate, CanaryReport
from .manifest import SHARED_ID, Manifest, ModuleRef, file_digest, \
    tree_digest
from .publisher import Publisher
from .registry import DeploymentRegistry

__all__ = ["CanaryGate", "CanaryReport", "DeploymentRegistry", "Manifest",
           "ModuleRef", "Publisher", "SHARED_ID", "file_digest",
           "tree_digest"]
