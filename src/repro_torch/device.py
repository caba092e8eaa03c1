"""The port's one device rule: run on the card unless told otherwise.

Entry points take ``device=`` (default ``"cuda"``) and resolve it here.
Asking for CUDA where there is none raises; nothing falls back to the
CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain CPU path")
    return dev
