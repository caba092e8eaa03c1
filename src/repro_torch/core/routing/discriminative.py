"""Discriminative routing (paper §2.4.2, §7.2.1): documents scored by
every path, and a K-class linear router on g(document).

The router's training (logistic regression + bias calibration) waits
for the training slice of the port; a router is built from given
weights, e.g. copied from the reference's trained router.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import apply_lm, lm_loss

from .features import params_device


@torch.inference_mode()
def score_documents(path_params_list, cfg: ModelConfig, tokens,
                    batch_size: int = 32):
    """S[i, p] = summed log-likelihood of doc i under path p
    (excluding the routing prefix)."""
    cols = []
    for params in path_params_list:
        tk_all = torch.as_tensor(tokens, device=params_device(params))
        outs = []
        for i in range(0, tk_all.shape[0], batch_size):
            tk = tk_all[i:i + batch_size]
            logits, _ = apply_lm(params, cfg, tk)
            nll, _ = lm_loss(logits, tk, cfg.route_prefix_len)
            outs.append(-nll.sum(dim=-1))
        cols.append(torch.cat(outs))
    return torch.stack(cols, dim=1)  # (N, P)


@dataclass
class DiscriminativeRouter:
    w: torch.Tensor       # (D, P)
    b: torch.Tensor       # (P,)
    mu: torch.Tensor      # (D,) feature normalization
    sigma: torch.Tensor   # (D,)

    def logits(self, z):
        zn = (torch.as_tensor(z, dtype=torch.float32, device=self.w.device)
              - self.mu) / self.sigma
        return zn @ self.w + self.b

    def assign(self, z):
        return torch.argmax(self.logits(z), dim=-1)

    def assign_topn(self, z, n: int):
        return torch.topk(self.logits(z), n, dim=-1).indices
