"""Routing features g(document) (paper §7.2.1): the average of the last
transformer block's hidden state over the first 32 tokens, computed with
the base (pretrained) LM."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import apply_lm
from repro_torch.models.params import tree_leaves


def params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


@torch.inference_mode()
def prefix_features(params, cfg: ModelConfig, tokens, prefix_len=None,
                    batch_size: int = 64):
    """tokens: (N, S) -> (N, d_model) float32 features, on the params'
    device."""
    pl = prefix_len or cfg.route_prefix_len
    tokens = torch.as_tensor(tokens, device=params_device(params))
    outs = []
    for i in range(0, tokens.shape[0], batch_size):
        hidden, _ = apply_lm(params, cfg, tokens[i:i + batch_size, :pl],
                             return_hidden=True)
        outs.append(hidden.float().mean(dim=1))
    return torch.cat(outs, dim=0)
