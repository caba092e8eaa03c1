"""DiPaCo step builders (stacked-worker formulation); the port of
``repro/launch/steps.py``: the inner and synchronous train steps, the
streaming mesh phase whose fragment reduces run as collectives over the
ranks of a ``launch.mesh.WorkerMesh``, the prefill and decode steps, and
the dry-run's shape trees on the meta device.

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
import torch.distributed as dist

from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import (param_axes, param_shapes, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.optim import adamw_update_


# ---------------------------------------------------------------------------
# Shape trees on the meta device (no allocation, safe for 340B)
# ---------------------------------------------------------------------------
def model_param_shapes(cfg: ModelConfig):
    """(shapes, axes): ``init_model(cfg)``'s tree as meta tensors of its
    shapes and dtypes, from the shape rules of ``params.param_axes``
    (``init_model`` draws from a generator, and there is no meta one)."""
    dtype = torch_dtype(cfg.dtype)
    shapes = tree_map(lambda s: torch.empty(s, dtype=dtype, device="meta"),
                      param_shapes(cfg))
    return shapes, param_axes(cfg)


def worker_param_shapes(cfg: ModelConfig, num_workers: int):
    """``model_param_shapes`` stacked over a leading worker axis."""
    shapes, axes = model_param_shapes(cfg)
    return tree_map(lambda s: s.new_empty((num_workers, *s.shape)),
                    shapes), axes


def adamw_state_shapes(param_shapes):
    """``adamw_init``'s state for ``param_shapes``, on the meta device."""
    return {"m": tree_map(lambda s: torch.empty_like(s, dtype=torch.float32),
                          param_shapes),
            "v": tree_map(lambda s: torch.empty_like(s, dtype=torch.float32),
                          param_shapes),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


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
    return tree_map(lambda x: x[w], batch)


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


# ---------------------------------------------------------------------------
# Streaming mesh outer step (collectives over the worker ranks)
# ---------------------------------------------------------------------------
#
# The fragment schedule of the reference's ``make_streaming_mesh_phase``
# over the ranks of a ``launch.mesh.WorkerMesh``: the phase is split into
# K segments (core.fragments.segment_bounds); at the end of segment s
# fragment s's delta is cut, per-row quantized, and its gather started
# with ``async_op=True``; segment s+1 runs while it is in flight, and the
# update lands one segment later (applies touch only their own
# fragment's leaves).
#
# Bit-exactness against the single-process oracle
# (core.diloco.segmented_streaming_phase): every rank gathers the full
# (W, ...) wire leaf, evaluates the same full mixing einsum
# (core.diloco.mix_leaf) and keeps its own rows; no all_reduce, whose
# summation order would differ from the einsum's.  Quantization is per
# worker row on both sides, and the rest is elementwise on rows.

def worker_rows(mesh) -> slice:
    """The rank's slice of a leading worker axis (the counterpart of the
    reference's ``worker_partition_spec``)."""
    rows = mesh.rows
    return slice(rows.start, rows.stop)


class FragmentGather:
    """A fragment reduce in flight: ``wait()`` finishes every leaf's
    gather, mixes the full leaves and returns this rank's rows of the
    outer gradient, ``{leaf_idx: (W_local, ...)}``."""

    def __init__(self, works, parts, ax_list, mix_layers, mix_shared, rows):
        self._works, self._parts = works, parts
        self._mix = (ax_list, mix_layers, mix_shared)
        self._rows = rows

    def wait(self) -> dict:
        from repro_torch.core.diloco import mix_leaf
        for w in self._works:
            w.wait()
        ax_list, mixl, mixs = self._mix
        out = {}
        for i, chunks in self._parts.items():
            full = chunks[0] if len(chunks) == 1 else torch.cat(chunks, 0)
            out[i] = mix_leaf(full, ax_list[i], mixl, mixs)[self._rows]
        return out


def make_fragment_reduce_step(mesh, ax_list):
    """``(wire_f, mix_layers, mix_shared) -> FragmentGather``: every leaf
    of the wire fragment all_gathered over the mesh's ranks (the list
    form, ``async_op=True``), then, at ``wait()``, mixed with the full
    einsum that each rank evaluates identically and cut back to the
    rank's rows.  ``ax_list`` is the flatten-order logical-axes list
    (core.diloco.leaf_axes_list).  A world of one gathers too: the
    reference's (1, 1) mesh, one copy a leaf."""
    rows = worker_rows(mesh)

    def reduce(wire_f, mix_layers, mix_shared) -> FragmentGather:
        works, parts = [], {}
        for i, x in wire_f.items():
            x = x.contiguous()
            chunks = [torch.empty_like(x) for _ in range(mesh.world)]
            works.append(dist.all_gather(chunks, x, group=mesh.group,
                                         async_op=True))
            parts[i] = chunks
        return FragmentGather(works, parts, ax_list, mix_layers, mix_shared,
                              rows)

    return reduce


def make_segment_scan_fn(cfg: ModelConfig):
    """Inner-segment runner ``(worker_params, opt_state, batches, lrs) ->
    (worker_params, opt_state, losses)``: ``batches`` is an (S, W, B, T)
    token tensor and ``lrs`` holds S learning rates, one inner step
    (``make_inner_train_step``) each; ``losses`` is (S, W)."""
    inner = make_inner_train_step(cfg)

    def seg(worker_params, opt_state, batches, lrs):
        losses = []
        for t in range(batches.shape[0]):
            worker_params, opt_state, metrics = inner(
                worker_params, opt_state, {"tokens": batches[t]}, lrs[t])
            losses.append(metrics["loss"])
        return worker_params, opt_state, torch.stack(losses)

    return seg


def make_streaming_mesh_phase(cfg: ModelConfig, mesh, axes, fragspec, *,
                              comm_dtype: str = "fp32", outer_lr=0.7,
                              outer_momentum=0.9, outer_nesterov=True):
    """Build the overlapped streaming phase runner.

    Returns ``phase(worker_params, opt_state, global_params,
    frag_states, residuals, mix_layers, mix_shared, seg_batches,
    seg_lrs) -> (worker_params, opt_state, global_params, frag_states,
    residuals, losses)`` over this rank's rows of every worker-stacked
    tree, where ``seg_batches[s]`` / ``seg_lrs[s]`` hold segment ``s``'s
    inner-step inputs.  The dispatch order per segment is ``seg(s) ->
    apply(s-1) -> delta(s) -> reduce(s)``: reduce(s) is in flight while
    seg(s+1) computes.  Bit-exact to
    ``core.diloco.segmented_streaming_phase`` driven by the same segment
    function.  With ``fragspec.num_fragments == 1`` this is classic burst
    DiLoCo through the same code path.
    """
    from repro_torch.core.diloco import (leaf_axes_list,
                                         make_fragment_apply_fn,
                                         make_fragment_delta_fn)

    ax_list = leaf_axes_list(
        fragspec.unflatten(list(range(fragspec.num_leaves))), axes)
    seg_fn = make_segment_scan_fn(cfg)
    delta_fn = make_fragment_delta_fn(comm_dtype)
    reduce_fn = make_fragment_reduce_step(mesh, ax_list)
    apply_fn = make_fragment_apply_fn(
        lr=outer_lr, momentum=outer_momentum, nesterov=outer_nesterov)
    K = fragspec.num_fragments

    def _apply(pending, g_leaves, states, w_leaves):
        f, gather = pending
        og = gather.wait()
        new_g, new_s, new_w = apply_fn(
            og, {i: states[f][i] for i in og}, {i: g_leaves[i] for i in og},
            {i: w_leaves[i] for i in og})
        for i in og:
            g_leaves[i] = new_g[i]
            states[f][i] = new_s[i]
            w_leaves[i] = new_w[i]

    def phase(worker_params, opt_state, global_params, frag_states,
              residuals, mix_layers, mix_shared, seg_batches, seg_lrs):
        g_leaves = list(fragspec.flatten(global_params))
        states = [dict(s) for s in frag_states]
        resid = dict(residuals or {})
        losses = []
        pending = None
        wp, opt = worker_params, opt_state
        for s in range(K):
            wp, opt, seg_losses = seg_fn(wp, opt, seg_batches[s],
                                         seg_lrs[s])
            losses.append(seg_losses)
            w_leaves = list(fragspec.flatten(wp))
            if pending is not None:
                _apply(pending, g_leaves, states, w_leaves)
                wp = fragspec.unflatten(w_leaves)
            idx = fragspec.indices[s]
            r_f = ({i: resid[i] for i in idx}
                   if all(i in resid for i in idx) else None)
            wire, new_r = delta_fn({i: w_leaves[i] for i in idx},
                                   {i: g_leaves[i] for i in idx}, r_f)
            if new_r is not None:
                resid.update(new_r)
            pending = (s, reduce_fn(wire, mix_layers, mix_shared))
        w_leaves = list(fragspec.flatten(wp))
        _apply(pending, g_leaves, states, w_leaves)
        wp = fragspec.unflatten(w_leaves)
        return (wp, opt, fragspec.unflatten(g_leaves), states, resid,
                torch.cat(losses, 0))

    return phase


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig):
    """Forward scoring over stacked workers: ``(worker_params, batch) ->
    logits (W, b, S, V)`` for a batch dict of (W, b, ...) tensors."""
    def step(worker_params, batch):
        return torch.stack([
            api.forward_logits(row(worker_params, w), cfg,
                               _worker_batch(batch, w))[0]
            for w in range(batch["tokens"].shape[0])])

    return step


def make_decode_step(cfg: ModelConfig, *, window=None, stacked: bool = True):
    """One-token decode, ``(params, batch, cache, index) -> (logits,
    cache)``; ``stacked=False`` for a single path (long context).  The
    stacked step walks the workers, each decoding into its row of the
    (W, ...) caches in place."""
    def one(params, batch, cache, index):
        return api.serve_step(params, cfg, batch, cache, index,
                              window=window)

    if not stacked:
        return one

    def step(worker_params, batch, caches, index):
        logits = [one(row(worker_params, w), _worker_batch(batch, w),
                      row(caches, w), index)[0]
                  for w in range(batch["tokens"].shape[0])]
        return torch.stack(logits), caches

    return step
