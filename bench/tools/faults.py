"""Faults planted under the timed path, to show that the comparison
catches them (``tools/control.py`` on the card, ``tests/`` on the CPU).
No benchmark run plants one: the drivers call these with the empty
tuple.

Training: ``frozen`` (the inner step leaves the weights and optimizer
state unchanged), ``half_batch`` (each worker's step sees the first half
of its batch, the loss the mean over it), ``no_exchange`` (the outer
step mixes no worker's delta into another's), ``answer`` (the loss the
first step reports for worker 0 altered by a tenth where it is
produced).  Serving: ``frozen`` (decode
leaves the KV cache unchanged), ``answer`` (each request's fifth token
altered where it is emitted), ``route`` (the router's answer altered:
each request goes to the next path).  ``control`` is not a fault: the reference
in float8 is put in the program's place.
"""
from __future__ import annotations

import torch

TRAIN = ("frozen", "half_batch", "no_exchange", "answer")
SERVE = ("frozen", "answer", "route")


def plant_trainer(faults, tr):
    """Plant the trainer's faults; -> a callable that takes them out."""
    undo = []
    if "frozen" in faults:
        from repro_torch.launch import steps
        saved = steps.adamw_update_
        steps.adamw_update_ = lambda *a, **k: None
        undo.append(lambda: setattr(steps, "adamw_update_", saved))
    if "half_batch" in faults:
        inner = tr._step_fn

        def half(wp, opt, batch, lr):
            tok = batch["tokens"]
            return inner(wp, opt, {"tokens": tok[:, :tok.shape[1] // 2]}, lr)

        tr._step_fn = half
    if "answer" in faults:
        step = tr._step_fn
        calls = []

        def altered(wp, opt, batch, lr):
            out = step(wp, opt, batch, lr)
            if not calls:
                out[2]["loss"][0] *= 1.1
            calls.append(1)
            return out

        tr._step_fn = altered
    if "no_exchange" in faults:
        w = tr.mix_shared.shape[0]
        eye = torch.eye(w, device=tr.mix_shared.device)
        tr.mix_layers = eye.expand_as(tr.mix_layers).contiguous()
        tr.mix_shared = eye
    return lambda: [u() for u in undo]


def plant_engine(faults, eng):
    """Plant the engine's faults (before its warm-up, so that a captured
    tick holds them); -> a callable that takes them out."""
    undo = []
    if "frozen" in faults:
        from repro_torch.models import layers
        saved = layers._row_update_
        layers._row_update_ = lambda *a, **k: None
        undo.append(lambda: setattr(layers, "_row_update_", saved))
    if "answer" in faults:
        emit = eng._emit_tick
        vocab = eng.cfg.vocab_size

        def altered(now):
            done = emit(now)
            for st in eng.in_flight.values():
                if len(st.tokens) - len(st.req.prompt) == 5:
                    st.tokens[-1] = (st.tokens[-1] + 1) % vocab
            return done

        eng._emit_tick = altered
    if "route" in faults:
        router = eng.router

        class NextPath:
            def assign(self, z):
                return (router.assign(z) + 1) % len(eng.paths)

        eng.router = NextPath()
    return lambda: [u() for u in undo]
