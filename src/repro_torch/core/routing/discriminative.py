"""Discriminative routing (paper §2.4.2, §7.2.1).

1. Score every router-data document with every path (summed
   autoregressive log-likelihood S_ijp).
2. Targets = argmax_p sum_j S_ijp.
3. Train a K-class linear logistic classifier on g(document).
4. Calibrate a bias term so the predicted document->path distribution
   matches the target distribution (the paper's remedy for starved
   paths).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

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


def train_discriminative_router(feats, targets, num_paths: int, *,
                                steps: int = 500, lr: float = 0.1,
                                weight_decay: float = 1e-4,
                                target_dist=None, calibrate: bool = True,
                                generator: Optional[torch.Generator] = None,
                                init_w: Optional[torch.Tensor] = None
                                ) -> DiscriminativeRouter:
    """K-class linear logistic regression by full-batch gradient descent
    (plain autograd, no optimizer class) + bias calibration.  The
    weights start from ``init_w`` or from N(0, 0.01^2) drawn from
    ``generator``."""
    z0 = torch.as_tensor(feats, dtype=torch.float32)
    mu = z0.mean(0)
    sigma = torch.clamp_min(z0.std(0, unbiased=False), 1e-6)
    z = (z0 - mu) / sigma
    y = torch.as_tensor(targets, device=z.device).long()
    d = z.shape[-1]
    if init_w is not None:
        w = torch.as_tensor(init_w, dtype=torch.float32, device=z.device)
    else:
        w = torch.randn((d, num_paths), generator=generator,
                        device=z.device) * 0.01
    b = torch.zeros((num_paths,), device=z.device)

    for _ in range(steps):
        w_ = w.detach().requires_grad_(True)
        b_ = b.detach().requires_grad_(True)
        ll = F.log_softmax(z @ w_ + b_, dim=-1)
        nll = -torch.gather(ll, 1, y[:, None]).mean()
        loss = nll + weight_decay * torch.sum(w_ * w_)
        gw, gb = torch.autograd.grad(loss, (w_, b_))
        w, b = w - lr * gw, b - lr * gb

    if calibrate:
        # match predicted shard distribution to target (paper §7.2.1)
        if target_dist is None:
            target_dist = torch.bincount(y, minlength=num_paths).float()
            target_dist = target_dist / target_dist.sum()
        target_dist = torch.clamp_min(torch.as_tensor(
            target_dist, dtype=torch.float32, device=z.device), 1e-6)
        for _ in range(30):
            pred = torch.argmax(z @ w + b, dim=-1)
            frac = torch.bincount(pred, minlength=num_paths).float() \
                / pred.shape[0]
            b = b + 0.5 * (torch.log(target_dist)
                           - torch.log(torch.clamp_min(frac, 1e-6)))
    return DiscriminativeRouter(w=w, b=b, mu=mu, sigma=sigma)
