"""AdamW — the paper's inner optimizer (§2.5, Table 4: wd=0.1); the port
of ``repro/optim/adamw.py``, written out by hand.

Not ``torch.optim.AdamW`` nor ``clip_grad_norm_``: those round and clip
differently (the clip here is ``min(1, c / max(||g||, 1e-9))`` over the
whole tree, where torch adds 1e-6 to the norm).  Every step is computed
in f32 and the parameters are cast back to their dtype, as the
reference does.  ``adamw_update`` is functional and returns new trees;
``adamw_update_`` does the same f32 operations leaf by leaf and writes
the moments and the parameters in place, so the two give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.core import pytree
from repro_torch.models.params import tree_leaves, tree_map


def adamw_init(params):
    zeros = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                     params)
    device = tree_leaves(params)[0].device
    return {"m": zeros, "v": tree_map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in the reference's
    order (``jax.tree_util``: dict keys sorted), whatever the order in
    which the tree's dicts were built."""
    gsq = sum(torch.sum(torch.square(g.float()))
              for g in pytree.leaves(grads))
    return torch.sqrt(gsq)


def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0):
    """-> (new_params, new_state).  ``lr`` is a float or a 0-dim tensor."""
    count = state["count"] + 1
    if grad_clip is not None:
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
    else:
        grads = tree_map(lambda g: g.float(), grads)
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    c = count.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=c.device), c)

    def upd(p, m_, v_):
        step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "count": count}


@torch.no_grad()
def adamw_update_(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                  weight_decay=0.1, grad_clip=1.0) -> None:
    """``adamw_update`` in place: ``state`` ("m", "v", "count") and
    ``params`` are overwritten, one leaf at a time, so no second copy of
    the tree is ever held.  Call it after the backward has finished."""
    state["count"].add_(1)
    c = state["count"].float()
    scale = None
    if grad_clip is not None:
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=c.device), c)

    def upd(p, g, m_, v_):
        g = g.float() * scale if scale is not None else g.float()
        m_.mul_(b1).add_((1 - b1) * g)
        v_.mul_(b2).add_((1 - b2) * g * g)
        step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))

    def leaf(p, g, m_, v_):
        # elementwise, so a large leaf goes in slabs along its first axis:
        # the f32 temporaries stay a slab's size, the bits the same
        for parts in zip(*(slabs(t) for t in (p, g, m_, v_))):
            upd(*parts)

    tree_map(leaf, params, grads, state["m"], state["v"])


# elements of one slab of the in-place updates (64 MiB in f32)
SLAB_ELEMS = 1 << 24


def slabs(t: torch.Tensor, dim: int = 0) -> tuple:
    """Views of ``t`` along axis ``dim`` of at most about ``SLAB_ELEMS``
    elements each (``t`` itself when it is small or has no axis
    ``dim``)."""
    if t.ndim <= dim or t.numel() <= SLAB_ELEMS:
        return (t,)
    rows = max(1, SLAB_ELEMS // max(t.numel() // t.shape[dim], 1))
    return t.split(rows, dim=dim)
