"""Unified model API of the port over decoder LMs and encoder-decoders.

  init_model(cfg, seed=, device=)          -> params
  forward_logits(params, cfg, batch)       -> (logits, aux)
  forward_loss(params, cfg, batch)         -> (loss, aux dict)
  init_serve_cache(cfg, batch, cache_len, device=)
  prefill(params, cfg, batch, cache_len)   -> (logits, cache)
  serve_step(params, cfg, batch, cache, index, mask=) -> (logits, cache)

``batch`` holds ``tokens``, and ``patch_embeds`` for a VLM or
``frames`` (training) / ``enc_out`` and optionally ``cross_kv``
(decode) for an encoder-decoder.  ``serve_step`` (alias
``decode_step``) accepts a scalar index or a (B,) vector of per-row
positions, and updates ``cache`` in place.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import encdec as ED
from . import lm as LM
from .config import ModelConfig
from .lm import lm_loss_mean


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder is not None


def check_decoder(cfg: ModelConfig) -> None:
    """The engines and trainers take decoder LMs, as the reference's,
    which never pass an encoder-decoder its frames."""
    if is_encdec(cfg):
        raise ValueError(f"{cfg.name} is an encoder-decoder: the engines "
                         f"and trainers serve and train decoder LMs; drive "
                         f"it through repro_torch.models.api")


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the reference tree's keys, shapes and dtypes)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    if is_encdec(cfg):
        return ED.init_encdec(gen, cfg)
    return LM.init_lm(gen, cfg)


def forward_logits(params, cfg: ModelConfig, batch, *, window=None):
    if is_encdec(cfg):
        return ED.apply_encdec(params, cfg, batch["tokens"], batch["frames"],
                               window=window)
    return LM.apply_lm(params, cfg, batch["tokens"],
                       patch_embeds=batch.get("patch_embeds"),
                       window=window)


def forward_loss(params, cfg: ModelConfig, batch, *, window=None):
    logits, aux = forward_logits(params, cfg, batch, window=window)
    loss = lm_loss_mean(logits, batch["tokens"], cfg.route_prefix_len)
    return loss + aux, {"lm_loss": loss, "aux_loss": aux}


def init_serve_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                     device="cuda"):
    if is_encdec(cfg):
        return ED.init_encdec_cache(cfg, batch, cache_len, device=device)
    return LM.init_decode_cache(cfg, batch, cache_len, device=device)


def prefill(params, cfg: ModelConfig, batch, cache_len: int, *, window=None):
    """Prompt ingestion -> (logits, decode-ready cache).

    For decoder LMs this is one forward writing the cache at positions
    0..S-1 (logits (B,S,V)).  Encoder-decoders replay the prompt through
    ``serve_step`` one token at a time (logits (B,1,V)).  In both cases
    ``logits[:, -1]`` predicts the first generated token.
    """
    tokens = batch["tokens"]
    if is_encdec(cfg):
        cache = init_serve_cache(cfg, tokens.shape[0], cache_len,
                                 device=tokens.device)
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = serve_step(
                params, cfg, {**batch, "tokens": tokens[:, t:t + 1]},
                cache, t, window=window)
        return logits, cache
    return LM.prefill(params, cfg, tokens, cache_len, window=window,
                      patch_embeds=batch.get("patch_embeds"))


def serve_step(params, cfg: ModelConfig, batch, cache, index, *, window=None,
               mask=None):
    """One-token decode.  batch: dict(tokens (B,1) [+ enc_out and/or the
    precomputed cross_kv for encoder-decoders]).  ``mask`` (B,) bool:
    False rows leave their cache unchanged (decoder LMs; the reference's
    encoder-decoder decode has no mask)."""
    if is_encdec(cfg):
        if mask is not None:
            raise ValueError(f"{cfg.name}: the encoder-decoder decode takes "
                             f"no mask")
        return ED.decode_step_encdec(params, cfg, batch["tokens"],
                                     batch.get("enc_out"), cache, index,
                                     window=window,
                                     cross_kv=batch.get("cross_kv"))
    return LM.decode_step(params, cfg, batch["tokens"], cache, index,
                          window=window, mask=mask)


decode_step = serve_step
