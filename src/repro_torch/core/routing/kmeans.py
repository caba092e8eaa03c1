"""Generative routing (paper §2.4.1, Eq. 1): k-means and product k-means
(§7.3) on prefix features; the port of ``repro/core/routing/kmeans.py``.

The assignment goes through ``ops.router_assign`` (the CUDA kernel on the
card, its plain version on the CPU), where the reference computes the
same function in plain ``jnp``.  k-means++ seeding draws from a
``torch.Generator``; its numbers differ from ``jax.random``'s, so a
caller that needs the reference's clustering passes ``init=``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import ops


def _plusplus_init(z, k: int, generator: Optional[torch.Generator]):
    """k-means++ seeding."""
    n = z.shape[0]
    idx0 = torch.randint(n, (1,), generator=generator, device=z.device)
    centers = [z[idx0[0]]]
    d2 = torch.sum((z - centers[0]) ** 2, dim=-1)
    for _ in range(1, k):
        probs = d2 / torch.clamp_min(d2.sum(), 1e-9)
        idx = torch.multinomial(probs, 1, generator=generator)[0]
        c = z[idx]
        centers.append(c)
        d2 = torch.minimum(d2, torch.sum((z - c) ** 2, dim=-1))
    return torch.stack(centers)


def kmeans_assign(z, centroids):
    """Eq. 1: r(z) = argmin_i ||z - c_i||^2.  z: (N,D), c: (K,D) ->
    (assign (N,) int64, min d2 (N,) f32).  The reference returns the
    whole (N,K) distance matrix as its second value; its only use there
    is the minimum, which the kernel gives directly."""
    a, mind2 = ops.router_assign(z, centroids)
    return a.long(), mind2


@dataclass
class KMeansRouter:
    """Eq. 1 as a router: ``assign(z)`` is the nearest centroid (the
    ``router_assign`` kernel on the card), for the routers' callers
    (``frequent.chunk_choices``)."""
    centroids: torch.Tensor      # (K, D)

    def assign(self, z):
        z = torch.as_tensor(z, device=self.centroids.device)
        return kmeans_assign(z, self.centroids.to(z.dtype))[0]


def squared_distances(z, centroids):
    """The full (N,K) expanded distance matrix, in f32."""
    zf, cf = z.float(), centroids.float()
    return ((zf * zf).sum(-1, keepdim=True) - 2 * zf @ cf.T
            + (cf * cf).sum(-1)[None, :])


def kmeans_fit(z, k: int, iters: int = 25, *,
               generator: Optional[torch.Generator] = None,
               init: Optional[torch.Tensor] = None):
    """Lloyd iterations from k-means++ seeds (or from ``init``); returns
    (centroids (K,D), assignments (N,), inertia).

    The update sums the features of each cluster with ``index_add_``,
    which adds in another order than the reference's ``onehot.T @ z``:
    the centroids agree to f32 rounding of a mean (about 1e-6 relative).
    """
    z = torch.as_tensor(z).float().contiguous()
    c = (init.to(z.device, torch.float32) if init is not None
         else _plusplus_init(z, k, generator))
    for _ in range(iters):
        a, _ = kmeans_assign(z, c)
        counts = torch.bincount(a, minlength=k).float()
        sums = torch.zeros_like(c).index_add_(0, a, z)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp_min(counts[:, None], 1.0), c)
    a, mind2 = kmeans_assign(z, c)
    return c, a, mind2.sum()


def product_kmeans_fit(z, k_per_group: int, iters: int = 25, *,
                       generator: Optional[torch.Generator] = None):
    """Product k-means (§7.3): split features into two halves, k-means
    each; pair assignment indexes k^2 shards at sqrt cost."""
    z = torch.as_tensor(z).float()
    half = z.shape[-1] // 2
    c1, a1, _ = kmeans_fit(z[:, :half], k_per_group, iters,
                           generator=generator)
    c2, a2, _ = kmeans_fit(z[:, half:], k_per_group, iters,
                           generator=generator)
    return (c1, c2), a1 * k_per_group + a2


def product_kmeans_assign(z, centroids_pair):
    c1, c2 = centroids_pair
    z = torch.as_tensor(z).float()
    half = z.shape[-1] // 2
    a1, _ = kmeans_assign(z[:, :half], c1)
    a2, _ = kmeans_assign(z[:, half:], c2)
    return a1 * c2.shape[0] + a2


def topn_assign(z, centroids, n: int):
    """Overlapping shards (§2.4.4): each sequence joins its n closest.
    A top-n is not an argmin, so this takes the plain distance matrix."""
    return torch.topk(-squared_distances(torch.as_tensor(z), centroids), n,
                      dim=-1).indices   # (N, n)
