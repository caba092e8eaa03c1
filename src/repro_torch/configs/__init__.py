"""Architecture config registry of the port.

Each ``<arch>.py`` exposes ``config() -> ModelConfig`` and
``smoke() -> ModelConfig``, as in ``repro/configs``: the reference's
twelve, in its order.  Asking for any other name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

ASSIGNED_ARCHS = ["qwen3-moe-235b-a22b", "gemma-2b", "whisper-base",
                  "jamba-v0.1-52b", "mamba2-1.3b", "pixtral-12b", "qwen3-8b",
                  "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "nemotron-4-340b"]

PAPER_CONFIGS = ["dipaco-150m", "dipaco-dense-1b"]

ALL_CONFIGS = ASSIGNED_ARCHS + PAPER_CONFIGS


def _module(name: str):
    if name not in ALL_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_CONFIGS}")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke()
