"""DiLoCo-per-module outer optimization (paper Algorithm 1, lines
11-16); the port of ``repro/core/diloco.py``.

The *stacked-worker* formulation: every worker w holds its path's view of
the module store, as a tree of (W, ...) leaves.  The outer gradient of
worker w's module at repeat r is the mixing-matrix-weighted average of
deltas of all workers through that module; workers through the same
module compute identical updates, so their copies stay synchronized
without a central server.

The streaming part (Streaming DiLoCo: per-fragment windows, quantized
wire payloads with error feedback) indexes leaves in the reference's
``jax.tree_util`` order (``core.pytree``, ``core.fragments``); its
functions are the oracles the infra executors are held to.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import pytree
from repro_torch.core.fragments import fake_quantize, quantize_with_feedback
from repro_torch.models.params import LAYERS, tree_map, tree_map_with_axes
from repro_torch.optim import adamw
from repro_torch.optim.nesterov import nesterov_init, nesterov_update


def _is_layer_leaf(axes_leaf, shape, num_repeats) -> bool:
    return (len(axes_leaf) >= 1 and axes_leaf[0] == LAYERS
            and len(shape) >= 2 and shape[1] == num_repeats)


def mix_leaf(d, ax, mix_layers, mix_shared, layer=None):
    """Mix one worker-stacked (W, ...) leaf with the per-repeat layer
    matrix (R,W,W) or the shared matrix (W,W), in f32.  ``layer`` says
    which (found from ``ax`` and the shape when None)."""
    if layer is None:
        layer = _is_layer_leaf(ax, d.shape, mix_layers.shape[0])
    d32 = d.float()
    if layer:
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
    # redistribute: worker copies <- updated module store view (copies:
    # an in-place inner step must not write through into the globals)
    new_worker = tree_map(lambda g, w: g.to(w.dtype, copy=True), new_global,
                          worker_params)
    return new_worker, new_global, new_state


def outer_state_init(global_params):
    return nesterov_init(global_params)


@torch.no_grad()
def outer_step_(worker_params, global_params, outer_state, axes, mix_layers,
                mix_shared, *, lr=0.7, momentum=0.9, nesterov=True) -> None:
    """:func:`outer_step` in place: the global copies, the momentum and
    the workers' copies are overwritten leaf by leaf, in slabs along the
    repeat axis (``adamw.slabs`` along axis 1; a layer leaf's slab mixes
    with its repeats' matrices), so the f32 deltas and outer gradients
    are held a slab at a time.  The same f32 operations per element as
    :func:`outer_step`."""
    R = mix_layers.shape[0]

    def leaf(g, w, buf, ax):
        layer = _is_layer_leaf(ax, g.shape, R)
        lo = 0
        for gs, ws, bs in zip(*(adamw.slabs(t, dim=1) for t in (g, w, buf))):
            hi = lo + (gs.shape[1] if gs.ndim >= 2 else 0)
            og = mix_leaf(gs.float() - ws.float(), ax, mix_layers[lo:hi],
                          mix_shared, layer=layer)
            lo = hi
            bs.mul_(momentum).add_(og)
            d = og + momentum * bs if nesterov else bs
            gs.copy_((gs.float() - lr * d).to(gs.dtype))
            ws.copy_(gs.to(ws.dtype))

    tree_map(leaf, global_params, worker_params, outer_state["momentum"],
             axes)


def leaf_axes_list(template, axes) -> list:
    """Per-leaf logical-axes tuples aligned with ``core.pytree.flatten``
    order of ``template`` (the order ``FragmentSpec`` indexes by)."""
    leaves, treedef = pytree.flatten(template)
    ax, ax_def = pytree.flatten(axes, is_leaf=lambda x: isinstance(x, tuple))
    if ax_def != treedef:
        raise ValueError(f"axes tree {ax_def} does not match {treedef}")
    return [tuple(a) for a in ax]


# ---------------------------------------------------------------------
# streaming fragment-wise outer sync (Streaming DiLoCo)
# ---------------------------------------------------------------------

def fragment_state_init(global_params, spec):
    """Per-fragment Nesterov states: ``states[f]`` maps leaf index ->
    fp32 momentum buffer for the leaves of fragment ``f``."""
    leaves = spec.flatten(global_params)
    return [{i: torch.zeros(leaves[i].shape, dtype=torch.float32,
                            device=leaves[i].device)
             for i in spec.indices[f]}
            for f in range(spec.num_fragments)]


def _nesterov_leaf(og, mom, g, *, lr, momentum, nesterov):
    upd, st = nesterov_update({"x": og}, {"momentum": {"x": mom}}, {"x": g},
                              lr=lr, momentum=momentum, nesterov=nesterov)
    return upd["x"], st["momentum"]["x"]


def streaming_outer_step(worker_params, global_params, frag_states, axes,
                         mix_layers, mix_shared, spec, *,
                         sync_fragments=None, comm_dtype="fp32",
                         lr=0.7, momentum=0.9, nesterov=True):
    """Per-fragment ``outer_step``: only the leaves of the fragments in
    ``sync_fragments`` are synchronized; every synced fragment advances
    its own Nesterov state, unsynced fragments (and their worker copies)
    are left untouched.  ``comm_dtype`` != fp32 quantize-dequantizes each
    worker's delta before mixing (error feedback lives with the caller).
    With one fragment, every fragment synced and fp32 this is
    :func:`outer_step`, bit for bit."""
    sync = (range(spec.num_fragments) if sync_fragments is None
            else sorted(set(int(f) for f in sync_fragments)))
    deltas = tree_map(lambda g, w: g.float() - w.float(), global_params,
                      worker_params)
    deltas = fake_quantize(deltas, comm_dtype)
    og = mix_deltas(deltas, axes, mix_layers, mix_shared)
    og_leaves = spec.flatten(og)
    g_leaves = list(spec.flatten(global_params))
    new_states = [dict(s) for s in frag_states]
    for f in sync:
        for i in spec.indices[f]:
            g_leaves[i], new_states[f][i] = _nesterov_leaf(
                og_leaves[i], new_states[f][i], g_leaves[i], lr=lr,
                momentum=momentum, nesterov=nesterov)
    new_global = spec.unflatten(g_leaves)
    # redistribute only the synced fragments: unsynced leaves keep the
    # workers' own (inner-trained) values
    synced = {i for f in sync for i in spec.indices[f]}
    w_leaves = list(spec.flatten(worker_params))
    for i in synced:
        w_leaves[i] = g_leaves[i].to(w_leaves[i].dtype, copy=True)
    return spec.unflatten(w_leaves), new_global, new_states


def rowwise_quantize_with_feedback(delta, residual, comm_dtype):
    """Per-worker-row ``quantize_with_feedback`` on worker-stacked
    leaves: each worker quantizes its own delta with its own scale (the
    reference ``vmap``s over the rows; here a loop).  ``residual`` may be
    ``None``.  Returns ``(wire, new_residual)``, ``None`` for fp32."""
    if comm_dtype == "fp32":
        return delta, None
    if residual is None:
        residual = pytree.tree_map(
            lambda d: torch.zeros(d.shape, dtype=torch.float32,
                                  device=d.device), delta)
    rows = pytree.leaves(delta)[0].shape[0]
    wires, resids = [], []
    for w in range(rows):
        wire, res = quantize_with_feedback(
            pytree.tree_map(lambda x: x[w], delta),
            pytree.tree_map(lambda x: x[w], residual), comm_dtype)
        wires.append(wire)
        resids.append(res)
    return (pytree.tree_map(lambda *xs: torch.stack(xs), *wires),
            pytree.tree_map(lambda *xs: torch.stack(xs), *resids))


def make_fragment_delta_fn(comm_dtype: str):
    """``(w_f, g_f, resid_f) -> (wire_f, new_resid_f)`` over one
    fragment's ``{leaf_idx: (W, ...)}`` dicts: delta = global - worker,
    then per-worker-row quantize with error feedback."""
    def fn(w_f, g_f, resid_f):
        delta = {i: g_f[i].float() - w_f[i].float() for i in w_f}
        return rowwise_quantize_with_feedback(delta, resid_f, comm_dtype)

    return fn


def make_fragment_apply_fn(*, lr=0.7, momentum=0.9, nesterov=True):
    """Per-fragment outer update: ``(og_f, state_f, g_f, w_f) ->
    (new_g_f, new_state_f, new_w_f)``, one Nesterov update per leaf.  The
    workers' new leaves are copies of the global ones, never the same
    tensors (even in f32), so an in-place inner step on the workers
    leaves the global copies as they are."""
    def fn(og_f, state_f, g_f, w_f):
        new_g, new_s, new_w = {}, {}, {}
        for i in og_f:
            new_g[i], new_s[i] = _nesterov_leaf(
                og_f[i], state_f[i], g_f[i], lr=lr, momentum=momentum,
                nesterov=nesterov)
            new_w[i] = new_g[i].to(w_f[i].dtype, copy=True)
        return new_g, new_s, new_w

    return fn


def segmented_streaming_phase(inner_seg, worker_params, global_params,
                              frag_states, residuals, axes, mix_layers,
                              mix_shared, spec, *, comm_dtype="fp32",
                              lr=0.7, momentum=0.9, nesterov=True):
    """Single-process oracle for the overlapped streaming schedule: the
    phase is split into ``K = spec.num_fragments`` inner segments
    (``inner_seg(s, worker_params) -> worker_params``), and each
    iteration runs ``seg(s) -> apply(s-1) -> delta(s) -> quantize ->
    mix``; the last fragment applies at the phase boundary.  With
    ``K == 1`` this is classic burst DiLoCo.  Returns ``(worker_params,
    global_params, frag_states, residuals)``."""
    K = spec.num_fragments
    ax_list = leaf_axes_list(global_params, axes)
    g_leaves = list(spec.flatten(global_params))
    w_leaves = list(spec.flatten(worker_params))
    new_states = [dict(st) for st in frag_states]
    new_resid = dict(residuals or {})
    delta_fn = make_fragment_delta_fn(comm_dtype)
    apply_fn = make_fragment_apply_fn(lr=lr, momentum=momentum,
                                      nesterov=nesterov)

    def _apply(f, og_f):
        state_f = {i: new_states[f][i] for i in og_f}
        g_f = {i: g_leaves[i] for i in og_f}
        w_f = {i: w_leaves[i] for i in og_f}
        new_g, new_s, new_w = apply_fn(og_f, state_f, g_f, w_f)
        for i in og_f:
            g_leaves[i] = new_g[i]
            new_states[f][i] = new_s[i]
            w_leaves[i] = new_w[i]

    pending = None
    for s in range(K):
        worker_params = inner_seg(s, spec.unflatten(w_leaves))
        w_leaves = list(spec.flatten(worker_params))
        if pending is not None:
            _apply(*pending)
        idx = spec.indices[s]
        w_f = {i: w_leaves[i] for i in idx}
        g_f = {i: g_leaves[i] for i in idx}
        resid = ({i: new_resid[i] for i in idx}
                 if all(i in new_resid for i in idx) else None)
        wire, res_out = delta_fn(w_f, g_f, resid)
        if res_out is not None:
            new_resid.update(res_out)
        og = {i: mix_leaf(wire[i], ax_list[i], mix_layers, mix_shared)
              for i in idx}
        pending = (s, og)
    _apply(*pending)
    return (spec.unflatten(w_leaves), spec.unflatten(g_leaves),
            new_states, new_resid)


def _window_scale(n: int, weights, rescale: bool) -> float:
    wsum = float(sum(weights))
    return (math.sqrt(n) if rescale else 1.0) / max(wsum, 1e-12)


def fragment_window_outer_gradient(segs, weights, spec, fragment, *,
                                   rescale=True):
    """:func:`window_outer_gradient` restricted to one fragment:
    ``{leaf_idx: outer_gradient}`` over the fragment's leaves."""
    scale = _window_scale(len(segs), weights, rescale)
    acc: dict = {}
    for seg, w in zip(segs, weights):
        for i, leaf in spec.slice_leaves(seg, fragment).items():
            term = float(w) * leaf.float()
            acc[i] = term if i not in acc else acc[i] + term
    return {i: a * scale for i, a in acc.items()}


def quorum_size(frac: float, n_active: int) -> int:
    """Contributors required to fire a window when ``n_active`` workers
    are live: ``ceil(frac * n_active)``, at least 1."""
    return max(1, math.ceil(frac * max(int(n_active), 1)))


def window_outer_gradient(segs, weights, *, rescale=True):
    """Lag-aware executor-window equivalence oracle (§3.3 async):
    ``g = sqrt(|S|) / (sum_S alpha_w) * sum_S alpha_w d_w`` over the
    contributor slices ``segs`` and their alphas ``weights``."""
    scale = _window_scale(len(segs), weights, rescale)
    acc = None
    for seg, w in zip(segs, weights):
        term = pytree.tree_map(lambda x, _w=float(w): _w * x.float(), seg)
        acc = term if acc is None else pytree.tree_map(
            lambda a, t: a + t, acc, term)
    return pytree.tree_map(lambda a: a * scale, acc)
