"""The reference of the first inner steps and the outer step of DiPaCo
training (paper Algorithm 1, §2.5-2.7): each worker takes ``steps``
AdamW steps on its shard's batches, then the outer step mixes the
workers' deltas module by module and applies Nesterov momentum.

Written from the paper and the trainer's documented settings, not from
the program: the partition of the repeats into levels, the mixing
weights (shard-size reweighing, Eq. 2-3, and the sqrt(P) rescale of
§2.7), the cosine schedule with linear warm-up, AdamW with a global
gradient-norm clip, and the batch schedule keyed by shard and phase.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from bench import sketch
from bench.reference.model import build

BETA1, BETA2, EPS, WEIGHT_DECAY, CLIP = 0.9, 0.95, 1e-8, 0.1, 1.0
OUTER_LR, OUTER_MOMENTUM = 0.7, 0.9


def lr_at(step: int, peak: float, warmup: int, total: int,
          final_frac: float = 0.1) -> float:
    """Cosine decay to ``final_frac`` of the peak after a linear
    warm-up from 0."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return final_frac * peak + (1 - final_frac) * peak * 0.5 * (
        1 + math.cos(math.pi * t))


def phase_rows(num_docs: int, batch: int, steps: int, shard: int,
               phase: int) -> np.ndarray:
    """The (steps, batch) document indices a shard trains on in a phase:
    drawn with replacement from a generator keyed by (shard, phase)."""
    rng = np.random.default_rng(1000 + shard * 131 + phase * 7919)
    return rng.integers(0, num_docs, size=(steps, batch))


def level_bounds(levels, num_layers: int) -> list:
    n = len(levels)
    return [round(i * num_layers / n) for i in range(n + 1)]


def mixing(levels, num_layers: int, sizes) -> tuple:
    """(per-layer (R, W, W), shared (W, W)) weights with which worker v's
    delta enters worker w's outer gradient: the workers through the same
    module, weighted by shard size and rescaled by the square root of
    their number; the embeddings and final norm are shared by all."""
    paths = np.array(list(itertools.product(*[range(k) for k in levels])))
    w_count = len(sizes)
    hosted = paths[np.arange(w_count) % len(paths)]
    alphas = np.asarray(sizes, np.float64) / max(np.sum(sizes), 1)
    bounds = level_bounds(levels, num_layers)
    layers = np.zeros((num_layers, w_count, w_count))
    for r in range(num_layers):
        lvl = max(i for i in range(len(levels)) if bounds[i] <= r)
        same = (hosted[:, lvl][:, None] == hosted[:, lvl][None, :])
        wgt = same * alphas[None, :]
        layers[r] = wgt / wgt.sum(1, keepdims=True) \
            * np.sqrt(same.sum(1, keepdims=True))
    shared = np.broadcast_to(alphas[None, :] / alphas.sum(),
                             (w_count, w_count)) * np.sqrt(w_count)
    return layers, shared


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def inner_steps(base: dict, m: dict, batches, *, precision: str,
                lr: list, micro: int, prefix_len: int, seed: int) -> tuple:
    """One worker's AdamW steps from ``base`` on ``batches`` (steps, B,
    S) -> (final params, per-step losses, per-leaf norms of the first
    step's clipped gradient, its sketch)."""
    params = {k: v.clone().requires_grad_(True) for k, v in base.items()}
    mom = {k: torch.zeros_like(v) for k, v in base.items()}
    var = {k: torch.zeros_like(v) for k, v in base.items()}
    model = build(params, m, precision)
    losses, first = [], None
    for t, batch in enumerate(batches):
        total, count = 0.0, 0
        grads = {k: torch.zeros_like(v) for k, v in base.items()}
        for i in range(0, batch.shape[0], micro):
            nll, n = model.nll_sum(batch[i:i + micro], prefix_len)
            count += n
            g = torch.autograd.grad(nll, list(params.values()))
            for k, gk in zip(params, g):
                grads[k] += gk
            total += float(nll.detach())
        losses.append(total / count)
        with torch.no_grad():
            grads = {k: g / count for k, g in grads.items()}
            gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                                  for g in grads.values()))
            scale = min(1.0, CLIP / max(gnorm, 1e-9))
            grads = {k: g * scale for k, g in grads.items()}
            if first is None:
                first = leaf_norms(grads)
                proj = {k: v[0] for k, v in
                        sketch.projections(grads, seed).items()}
            bc1, bc2 = 1 - BETA1 ** (t + 1), 1 - BETA2 ** (t + 1)
            for k, p in params.items():
                mom[k].mul_(BETA1).add_((1 - BETA1) * grads[k])
                var[k].mul_(BETA2).add_((1 - BETA2) * grads[k] ** 2)
                step = (mom[k] / bc1) / (torch.sqrt(var[k] / bc2) + EPS)
                p.sub_(lr[t] * (step + WEIGHT_DECAY * p))
    return {k: v.detach() for k, v in params.items()}, losses, first, proj


def outer_changes(base: dict, finals: list, levels, sizes,
                  num_layers: int) -> list:
    """Per worker, the per-leaf norms of the change of its module store
    copy after the outer step (its first: the momentum starts at 0)."""
    layers, shared = mixing(levels, num_layers, sizes)
    layers = torch.as_tensor(layers, dtype=torch.float32)
    shared = torch.as_tensor(shared, dtype=torch.float32)
    out = [dict() for _ in finals]
    for k, b in base.items():
        deltas = torch.stack([b - f[k] for f in finals])   # (W, ...)
        if k.startswith("blocks/"):
            mixed = torch.einsum("rwv,vr...->wr...",
                                 layers.to(b.device), deltas)
        else:
            mixed = torch.einsum("wv,v...->w...", shared.to(b.device), deltas)
        # Nesterov from zero momentum: buf = g, step = g + mu * buf
        change = -OUTER_LR * (1 + OUTER_MOMENTUM) * mixed
        for w in range(len(finals)):
            out[w][k] = float(torch.linalg.vector_norm(change[w].double()))
    return out
