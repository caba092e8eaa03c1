"""Slot-pooled KV/SSM cache arena for continuous batching.

The port of ``repro/serving/cache.py``.  One :class:`SlotArena` per path
island holds a decode cache from ``api.init_serve_cache`` whose batch
axis (axis 1, after the layer axis) is ``num_slots``; a request occupies
one slot row from admission to completion.  Allocation and free are
O(1) host-side bookkeeping; cache rows are written in place
(``index_copy_`` on the slot axis), never rebuilt per request, and no
row other than the ones named is written.

Stale rows need no zeroing: the attention mask only admits ring entries
whose reconstructed absolute position is in ``[0, current position]``,
and a prefill overwrites positions ``0..S-1`` of its row, so a freshly
allocated slot can never attend a previous occupant's keys.

:class:`PrefixCache` adds cross-request reuse on top of the arenas:
prefill rows are remembered content-keyed by ``(path, deployment
version, prompt tokens)``.  It stores clones, because arena writes and
decode happen in place.

:class:`StackedSlotArenas` keeps the caches of P homogeneous islands in
one tree whose leaves are ``(reps, P, S, ...)``: layer ``l``'s slice
``leaf[l]`` is contiguous, so it reshapes to the ``(P*S, T, KH, D)``
rows that one flash-decode launch takes without a copy, and
``leaf[l, p]`` is island ``p``'s rows; each island is a plain
:class:`SlotArena` over its rows of the stack.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map


class SlotExhausted(Exception):
    """Raised by :meth:`SlotArena.alloc` when no slot is free."""


def _write_rows_(arena, rows, slots: torch.Tensor) -> None:
    """arena leaves (reps, num_slots, ...), rows (reps, R', ...) with R'
    >= len(slots): rows[:, i] -> arena[:, slots[i]] in place (padded
    bucket rows beyond len(slots) are ignored)."""
    n = slots.numel()
    tree_map(lambda a, r: a.index_copy_(1, slots, r[:, :n].to(a.dtype)),
             arena, rows)


class SlotArena:
    """Fixed-size pool of per-request cache slots for one path island."""

    def __init__(self, cfg: ModelConfig, num_slots: int, cache_len: int, *,
                 device="cuda", cache=None, positions=None, active=None):
        """``cache`` (leaves (reps, num_slots, ...)), ``positions`` and
        ``active`` (numpy (num_slots,)) adopt storage that already exists,
        such as one island's rows of a :class:`StackedSlotArenas`; each
        is allocated here when None."""
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.cache = (api.init_serve_cache(cfg, num_slots, cache_len,
                                           device=device)
                      if cache is None else cache)
        self.device = torch.device(device)
        self._free = list(range(num_slots - 1, -1, -1))
        # per-slot next write position; parked at 0 while free
        self.positions = (np.zeros(num_slots, np.int32) if positions is None
                          else positions)
        self.active = np.zeros(num_slots, bool) if active is None else active

    # -- bookkeeping ---------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise SlotExhausted(f"all {self.num_slots} slots in use")
        slot = self._free.pop()
        self.active[slot] = True
        self.positions[slot] = 0
        return slot

    def try_alloc(self):
        """Like :meth:`alloc` but returns None instead of raising."""
        try:
            return self.alloc()
        except SlotExhausted:
            return None

    def free(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self.positions[slot] = 0
        self._free.append(slot)

    # -- cache movement ------------------------------------------------
    def write_slots(self, sub_cache, slots, positions) -> None:
        """Copy a batch-R cache tree into arena rows ``slots`` in place.

        ``positions[i]`` is the number of valid tokens row ``i`` holds
        (the next decode index for that request).
        """
        slots = np.asarray(slots, np.int64)
        _write_rows_(self.cache, sub_cache,
                     torch.as_tensor(slots, device=self.device))
        for s, p in zip(slots, np.asarray(positions, np.int32)):
            self.positions[s] = p

    def decode_indices(self) -> np.ndarray:
        """(num_slots,) per-row cache_index vector for a decode tick."""
        return self.positions.copy()


class PrefixCache:
    """Content-keyed cross-request reuse of prefill cache rows.

    Entries map ``(path, version, tokens)`` to a single-slot cache tree
    (leaves ``(reps, 1, ...)``, one arena row) plus the next-token logits
    that forward produced.  ``lookup`` returns the longest usable entry:
    the exact prompt when present, else the longest *strict* prefix (the
    engine replays the remaining tokens through single-row decode
    steps).  ``put`` stores clones: the arenas and the replay write their
    rows in place, and must never write into an entry.

    LRU-bounded by entry count; versioned keys plus an explicit
    :meth:`invalidate` on hot swap keep a superseded deployment's rows
    from ever being served (and from pinning their memory).
    """

    def __init__(self, max_entries: int):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, "
                             f"got {max_entries}")
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0          # exact full-prompt reuse
        self.extensions = 0    # strict-prefix reuse + replay
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, path: int, version: int, tokens, row_cache,
            logits) -> None:
        key = (int(path), int(version), tuple(int(t) for t in tokens))
        self._entries.pop(key, None)
        self._entries[key] = (tree_map(torch.clone, row_cache),
                              torch.as_tensor(logits).clone())
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def lookup(self, path: int, version: int,
               tokens) -> Optional[Tuple[int, object, torch.Tensor]]:
        """Longest usable entry for ``tokens``: ``(n_cached, row_cache,
        logits)`` with ``n_cached == len(tokens)`` for an exact hit, a
        shorter strict prefix otherwise; None on miss.  The returned row
        is the stored one: copy it before writing into it."""
        toks = tuple(int(t) for t in tokens)
        for n in range(len(toks), 0, -1):
            key = (int(path), int(version), toks[:n])
            hit = self._entries.get(key)
            if hit is None:
                continue
            self._entries.move_to_end(key)
            if n == len(toks):
                self.hits += 1
            else:
                self.extensions += 1
            return n, hit[0], hit[1]
        self.misses += 1
        return None

    def invalidate(self) -> None:
        """Drop every entry (hot swap: a new version's keys never match
        old entries, but keeping them would pin superseded rows)."""
        self._entries.clear()


class StackedSlotArenas:
    """Joint slot arenas for ``num_paths`` homogeneous path islands.

    All paths of a DiPaCo deployment share one architecture, so their
    decode caches live in a single tree whose leaves are ``(reps, P,
    num_slots, ...)``: one decode dispatch advances every island a tick.
    Layer ``l``'s slice ``leaf[l]`` is contiguous, so its ``(P*S, T, KH,
    D)`` rows go to flash-decode without a copy (the reference's ``(P,
    reps, S, ...)`` would make every layer slice strided).

    ``arenas[p]`` is a plain :class:`SlotArena` over island ``p``: its
    cache is that island's rows of the stack (views, leaves ``(reps, S,
    ...)``), its ``positions`` and ``active`` are row ``p`` of the
    ``(P, S)`` arrays here, so every write lands in the stack.
    """

    def __init__(self, cfg: ModelConfig, num_paths: int, num_slots: int,
                 cache_len: int, *, device="cuda"):
        self.num_paths = num_paths
        self.num_slots = num_slots
        one = api.init_serve_cache(cfg, num_slots, cache_len, device=device)
        self.cache = tree_map(
            lambda x: x[:, None].repeat(1, num_paths,
                                        *([1] * (x.ndim - 1))), one)
        del one
        self.positions = np.zeros((num_paths, num_slots), np.int32)
        active = np.zeros((num_paths, num_slots), bool)
        self.arenas = [
            SlotArena(cfg, num_slots, cache_len, device=device,
                      cache=tree_map(lambda x, p=p: x[:, p], self.cache),
                      positions=self.positions[p], active=active[p])
            for p in range(num_paths)]
