"""A sketch of a gradient: its projections on a few Gaussian directions
drawn from the run's seed, leaf by leaf.  The program's first gradient
and the reference's are sketched alike on the run's device; the gap of
two sketches, over the reference's, estimates the relative error of the
whole gradient vector (where a norm hides an error of direction)."""
from __future__ import annotations

import torch

DIRECTIONS = 32


def projections(leaves: dict, seed: int, rows=None) -> dict:
    """{leaf: [[projection a direction] a row]} of ``leaves`` (sorted by
    name); ``rows`` is the number of leading worker rows, or None for
    leaves of one worker (one row)."""
    out = {}
    for i, name in enumerate(sorted(leaves)):
        x = leaves[name]
        stacked = x if rows is not None else x[None]
        per_row = [[] for _ in range(stacked.shape[0])]
        for j in range(DIRECTIONS):
            gen = torch.Generator(device=x.device).manual_seed(
                (seed * 1_000_003 + i * 1_009 + j) % (1 << 63))
            r = torch.randn(stacked.shape[1:], generator=gen,
                            device=x.device, dtype=torch.float32)
            for w in range(stacked.shape[0]):
                per_row[w].append(float(
                    (stacked[w].float() * r).sum(dtype=torch.float64)))
        out[name] = per_row
    return out
