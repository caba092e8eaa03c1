"""DiLoCo-per-module outer optimization (paper Algorithm 1, lines
11-16); the port of ``repro/core/diloco.py`` up to its streaming part.

The *stacked-worker* formulation: every worker w holds its path's view of
the module store, as a tree of (W, ...) leaves.  The outer gradient of
worker w's module at repeat r is the mixing-matrix-weighted average of
deltas of all workers through that module; workers through the same
module compute identical updates, so their copies stay synchronized
without a central server.  The streaming fragment-wise sync waits for
the checkpoint slice (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import LAYERS, tree_map, tree_map_with_axes
from repro_torch.optim.nesterov import nesterov_init, nesterov_update


def _is_layer_leaf(axes_leaf, shape, num_repeats) -> bool:
    return (len(axes_leaf) >= 1 and axes_leaf[0] == LAYERS
            and len(shape) >= 2 and shape[1] == num_repeats)


def mix_leaf(d, ax, mix_layers, mix_shared):
    """Mix one worker-stacked (W, ...) leaf with the per-repeat layer
    matrix (R,W,W) or the shared matrix (W,W), in f32."""
    R = mix_layers.shape[0]
    d32 = d.float()
    if _is_layer_leaf(ax, d.shape, R):
        return torch.einsum("rwv,vr...->wr...", mix_layers, d32)
    return torch.einsum("wv,v...->w...", mix_shared, d32)


def mix_deltas(deltas, axes, mix_layers, mix_shared):
    """deltas: worker-stacked (W, ...) tree; returns mixed outer gradients."""
    return tree_map_with_axes(
        lambda d, ax: mix_leaf(d, ax, mix_layers, mix_shared), deltas, axes)


def outer_gradients(worker_params, global_params, axes, mix_layers,
                    mix_shared):
    deltas = tree_map(lambda g, w: g.float() - w.float(), global_params,
                      worker_params)
    return mix_deltas(deltas, axes, mix_layers, mix_shared)


def outer_step(worker_params, global_params, outer_state, axes, mix_layers,
               mix_shared, *, lr=0.7, momentum=0.9, nesterov=True):
    """One outer optimization: returns (new_worker, new_global, new_state).

    After this step each worker's params equal its path's view of the
    updated module store (Algorithm 1 line 14 + redistribution).
    """
    og = outer_gradients(worker_params, global_params, axes, mix_layers,
                         mix_shared)
    new_global, new_state = nesterov_update(
        og, outer_state, global_params, lr=lr, momentum=momentum,
        nesterov=nesterov)
    # redistribute: worker copies <- updated module store view
    new_worker = tree_map(lambda g, w: g.to(w.dtype), new_global,
                          worker_params)
    return new_worker, new_global, new_state


def outer_state_init(global_params):
    return nesterov_init(global_params)
