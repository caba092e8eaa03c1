"""The numbers that decide ``correct``, each a gap between what the
program produced and what the reference works out from the same
inputs.  A number is held to its limit in ``cells/<cell>.json``."""
from __future__ import annotations

import numpy as np


def relative_gap(got, want) -> float:
    """max |got - want| / |want| over paired scalars."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def norm_gap(got: dict, want: dict, keep=None) -> tuple:
    """Per leaf, |got norm - want norm| over the larger of the leaf's
    reference norm and the median leaf's; -> (the worst gap, its leaf).
    ``keep`` limits the leaves compared."""
    keys = [k for k in want if keep is None or k in keep]
    med = float(np.median([want[k] for k in want]))
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def sketch_gaps(got: dict, want: dict, keep=None) -> dict:
    """Per leaf, the distance of two sketches (``bench/sketch.py``) over
    the larger of the leaf's reference sketch norm and the median
    leaf's."""
    norm = {k: float(np.linalg.norm(v)) for k, v in want.items()}
    diff = {k: float(np.linalg.norm(np.subtract(got[k], want[k])))
            for k in want}
    med = float(np.median(list(norm.values())))
    return {k: diff[k] / max(norm[k], med) for k in want
            if keep is None or k in keep}


def moving_leaves(grad_norms: dict, floor: float = 1e-3) -> set:
    """Leaves whose reference gradient is at least ``floor`` of the
    median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return {k for k, v in grad_norms.items() if v >= floor * med}


def verdict(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: [number, limit]}): correct when every number
    is finite and at most its limit, and no limit lacks its number."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and np.isfinite(value) and value <= limit
        ok = ok and bool(good)
        table[name] = [value, limit]
    return ok, table
