"""DiPaCo step builders (stacked-worker formulation); the port of
``repro/launch/steps.py::make_inner_train_step`` and
``make_sync_train_step``.

Worker trees hold (W, ...) leaves.  The reference ``vmap``s one worker's
step over W; here a Python loop walks the workers, because
``torch.func.vmap`` cannot pass through a ctypes kernel or a custom
autograd Function without a vmap rule.  Each step updates worker w's row
of the stacked weights and AdamW moments in place (``adamw_update_``,
the same bits as the reference's functional update), once w's backward
has finished, and returns the same trees.
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw_update_


def row(tree, i: int):
    """Worker ``i``'s view of a (W, ...) tree (no copy)."""
    return tree_map(lambda x: x[i], tree)


def value_and_grad(params, cfg: ModelConfig, batch) -> tuple:
    """-> (loss, parts, grads): ``api.forward_loss`` and its gradient
    with respect to every leaf of ``params`` (in the leaves' dtypes)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss, parts = api.forward_loss(tree_unflatten(params, leaves), cfg,
                                   batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
        tree_unflatten(params, grads)


def _worker_batch(batch, w: int) -> dict:
    return {k: v[w] for k, v in batch.items()}


def _stack_metrics(metrics: list) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_inner_train_step(cfg: ModelConfig):
    """(worker_params, opt_state, batch, lr) -> (params, opt, metrics).

    worker_params: (W, ...) stacked; opt_state: per-worker AdamW state,
    stacked the same way; both are updated in place and returned.
    batch: dict of (W, B_local, ...) tensors.  metrics["loss"] is (W,).
    """
    def step(worker_params, opt_state, batch, lr):
        metrics = []
        for w in range(batch["tokens"].shape[0]):
            params = row(worker_params, w)
            loss, parts, grads = value_and_grad(params, cfg,
                                                _worker_batch(batch, w))
            metrics.append({"loss": loss, **parts})
            adamw_update_(grads, row(opt_state, w), params, lr=lr)
            del grads
        return worker_params, opt_state, _stack_metrics(metrics)

    return step


def make_sync_train_step(cfg: ModelConfig, mix_layers, mix_shared, axes):
    """Fully-synchronous DiPaCo baseline (paper §4.5): per-step gradient
    mixing across paths, module by module, then one AdamW update per
    worker."""
    from repro_torch.core.diloco import mix_deltas

    def step(worker_params, opt_state, batch, lr):
        W = batch["tokens"].shape[0]
        metrics, grads = [], []
        for w in range(W):
            loss, parts, g = value_and_grad(row(worker_params, w), cfg,
                                            _worker_batch(batch, w))
            metrics.append({"loss": loss, **parts})
            grads.append(g)
        mixed = mix_deltas(tree_map(lambda *gs: torch.stack(gs), *grads),
                           axes, mix_layers, mix_shared)
        del grads
        for w in range(W):
            adamw_update_(row(mixed, w), row(opt_state, w),
                          row(worker_params, w), lr=lr)
        return worker_params, opt_state, _stack_metrics(metrics)

    return step
