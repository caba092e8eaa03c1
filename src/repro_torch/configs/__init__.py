"""Architecture config registry of the port.

Each ``<arch>.py`` exposes ``config() -> ModelConfig`` and
``smoke() -> ModelConfig``, as in ``repro/configs``.  The port declares
only the architectures it can run so far; asking for any other name
raises ``KeyError``.
"""
from __future__ import annotations

import importlib

ALL_CONFIGS = ["dipaco-150m", "dipaco-dense-1b", "mamba2-1.3b",
               "qwen2-moe-a2.7b", "qwen3-8b", "pixtral-12b",
               "moonshot-v1-16b-a3b", "jamba-v0.1-52b", "whisper-base"]

# declared by the reference package but not yet by the port: their head
# dims (256, 192) and query groups (12, 16) wait for the kernels' wider
# instantiations
_NOT_PORTED = ["qwen3-moe-235b-a22b", "gemma-2b", "nemotron-4-340b"]


def _module(name: str):
    if name not in ALL_CONFIGS:
        if name in _NOT_PORTED:
            raise KeyError(f"arch {name!r} is not ported to repro_torch yet; "
                           f"the port has: {ALL_CONFIGS}")
        raise KeyError(f"unknown arch {name!r}; known: {ALL_CONFIGS}")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke()
