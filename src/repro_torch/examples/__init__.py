"""The repository's five examples on the port, one module each:

    python -m repro_torch.examples.quickstart        [--device cuda|cpu]
    python -m repro_torch.examples.train_dipaco      --preset mini|paper
    python -m repro_torch.examples.serve_paths
    python -m repro_torch.examples.train_and_serve
    python -m repro_torch.examples.multiarch_smoke   [--arch <id>]

Each takes the flags, presets, stages and printed lines of its script in
``examples/`` and keeps its body in a ``run(...)`` function that
``main()`` calls with the script's defaults.  ``--device`` defaults to
``cuda`` and raises where there is no card; on the card the config's
attention goes through the flash-attention kernels
(``attn_impl="pallas"``), as the launchers do.  Where a script draws from
``jax.random``, the port draws from a seeded ``torch.Generator``, so its
printed numbers differ from the script's.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def on_device(cfg, device) -> tuple:
    """-> (torch.device, cfg): the device resolved (raising without a
    card) and, on a card, the config set to the attention kernels."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cfg = cfg.replace(attn_impl="pallas")
    return dev, cfg


def generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
