"""DiPaCo on PyTorch and CUDA (NVIDIA Hopper).

The port of the ``repro`` JAX package, one slice at a time.  It imports
``torch`` and ``numpy`` only; the JAX package is the reference it is
tested against, never a dependency.

Top-level lazy re-exports (PEP 562), so ``import repro_torch`` loads no
submodule until an attribute is used:

    params = repro_torch.init_model(cfg, seed=0, device="cuda")
    eng = repro_torch.PathServingEngine(cfg, [params], options=...)
    tr = repro_torch.make_trainer(cfg, dcfg, dataset, backend="vector")

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise instead of running on the CPU (tests pass ``device="cpu"``).
"""
from __future__ import annotations

import importlib

_LAZY = {
    "init_model": "repro_torch.models.api",
    "get_config": "repro_torch.configs",
    "get_smoke_config": "repro_torch.configs",
    "EngineOptions": "repro_torch.serving.engine",
    "PathServingEngine": "repro_torch.serving.engine",
    "DiscriminativeRouter": "repro_torch.core.routing.discriminative",
    "from_numpy_tree": "repro_torch.models.params",
    "to_numpy_tree": "repro_torch.models.params",
    "make_trainer": "repro_torch.training",
    "DiPaCoConfig": "repro_torch.models.config",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value     # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(list(globals()) + __all__))
