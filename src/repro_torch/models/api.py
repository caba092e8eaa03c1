"""Model API of the port (decoder LMs; encoder-decoders are not ported).

  init_model(cfg, seed=, device=)          -> params
  forward_logits(params, cfg, batch)       -> (logits, aux)
  forward_loss(params, cfg, batch)         -> (loss, aux dict)
  init_serve_cache(cfg, batch, cache_len, device=)
  prefill(params, cfg, batch, cache_len)   -> (logits, cache)
  serve_step(params, cfg, batch, cache, index, mask=) -> (logits, cache)

``serve_step`` (alias ``decode_step``) accepts a scalar index or a (B,)
vector of per-row positions, and updates ``cache`` in place.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import lm as LM
from .config import ModelConfig
from .lm import lm_loss_mean


def _check_decoder(cfg: ModelConfig) -> None:
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoders are not ported to repro_torch "
            f"yet (ROADMAP queue 1, item 4)")


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the reference tree's keys, shapes and dtypes)."""
    _check_decoder(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return LM.init_lm(gen, cfg)


def forward_logits(params, cfg: ModelConfig, batch, *, window=None):
    _check_decoder(cfg)
    return LM.apply_lm(params, cfg, batch["tokens"], window=window)


def forward_loss(params, cfg: ModelConfig, batch, *, window=None):
    logits, aux = forward_logits(params, cfg, batch, window=window)
    loss = lm_loss_mean(logits, batch["tokens"], cfg.route_prefix_len)
    return loss + aux, {"lm_loss": loss, "aux_loss": aux}


def init_serve_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                     device="cuda"):
    _check_decoder(cfg)
    return LM.init_decode_cache(cfg, batch, cache_len, device=device)


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *, window=None):
    """Single-pass prompt ingestion -> (logits (B,S,V), decode-ready
    cache); ``logits[:, -1]`` predicts the first generated token."""
    _check_decoder(cfg)
    return LM.prefill(params, cfg, batch["tokens"], cache_len, window=window)


def serve_step(params, cfg: ModelConfig, batch, cache, index, *, window=None,
               mask=None):
    """One-token decode.  batch: dict(tokens (B,1)).  ``mask`` (B,) bool:
    False rows leave their cache unchanged."""
    _check_decoder(cfg)
    return LM.decode_step(params, cfg, batch["tokens"], cache, index,
                          window=window, mask=mask)


decode_step = serve_step
