"""Train every assigned architecture family (reduced configs) for a few
AdamW steps: path composition is architecture-agnostic, including MoE,
SSM, hybrid, VLM and enc-dec backbones; the port of
``examples/multiarch_smoke.py``.

    PYTHONPATH=src python -m repro_torch.examples.multiarch_smoke \
        [--arch <id>] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_smoke_config
from repro_torch.data import SyntheticCorpus
from repro_torch.examples import add_device_flag, on_device
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import api
from repro_torch.optim import adamw_init, adamw_update


def train_one(arch: str, *, device="cuda", steps: int = 10,
              docs: int = 128) -> dict:
    """``steps`` AdamW steps of ``api.forward_loss`` on batches of 4
    corpus documents (with stub patch embeddings for the VLM and stub
    frames for the encoder-decoder)."""
    dev, cfg = on_device(get_smoke_config(arch).replace(route_prefix_len=8),
                         device)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=48, seed=0)
    tokens, _ = corpus.sample_documents(docs, return_domains=True)
    params = api.init_model(cfg, seed=0, device=dev)
    dtype = getattr(torch, cfg.dtype)

    def batch_of(idx):
        b = {"tokens": torch.as_tensor(tokens[idx], device=dev)}
        n = len(idx)
        if cfg.vision is not None:
            b["patch_embeds"] = torch.ones(
                (n, cfg.vision.num_patches, cfg.vision.d_patch), dtype=dtype,
                device=dev)
        if cfg.encoder is not None:
            b["frames"] = torch.ones(
                (n, cfg.encoder.source_len, cfg.encoder.d_source),
                dtype=dtype, device=dev)
        return b

    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    losses = []
    t0 = time.time()
    for _ in range(steps):
        idx = rng.integers(0, len(tokens), size=4)
        loss, _, grads = value_and_grad(params, cfg, batch_of(idx))
        params, opt = adamw_update(grads, opt, params, lr=1e-3)
        losses.append(float(loss))
    return {"arch": arch, "first": losses[0], "last": losses[-1],
            "losses": losses, "wall_s": time.time() - t0}


def run(*, archs=None, device="cuda", steps: int = 10,
        docs: int = 128) -> list:
    out = []
    for arch in archs or ASSIGNED_ARCHS:
        r = train_one(arch, device=device, steps=steps, docs=docs)
        trend = "↓" if r["last"] < r["first"] else "!"
        print(f"{r['arch']:24s} loss {r['first']:.3f} -> {r['last']:.3f} "
              f"{trend}  ({r['wall_s']:.1f}s)")
        out.append(r)
    return out


def parser() -> argparse.ArgumentParser:
    """The script's flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    add_device_flag(ap)
    return ap


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    return run(archs=[args.arch] if args.arch else None, device=args.device)


if __name__ == "__main__":
    main()
