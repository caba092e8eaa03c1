"""Nesterov momentum — the paper's outer optimizer (§7.1: lr=0.7,
mu=0.9); the port of ``repro/optim/nesterov.py``.

Operates on *outer gradients* Delta(l,e) = theta^{t-1} - avg_i theta_i^t
(Algorithm 1, line 13-14).  Functional: returns new trees."""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map


def nesterov_init(params):
    return {"momentum": tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), params)}


def nesterov_update(outer_grads, state, params, *, lr=0.7, momentum=0.9,
                    nesterov=True):
    new_buf = tree_map(lambda buf, g: momentum * buf + g.float(),
                       state["momentum"], outer_grads)

    def step(p, buf, g):
        d = g.float() + momentum * buf if nesterov else buf
        return (p.float() - lr * d).to(p.dtype)

    new_params = tree_map(step, params, new_buf, outer_grads)
    return new_params, {"momentum": new_buf}
