"""What the reference works out for a cell, from the benchmark's inputs
(the seed's documents and weights), the routing it is fed (the shards'
assignment, the router's centroids) and the program's outputs that it
judges: the readings of the first training steps, the served tokens and
the paths they were served on."""
from __future__ import annotations

import numpy as np
import torch

from bench import generator, weights
from bench.reference import compare, train
from bench.reference.model import build, precise


def f32_params(m: dict, seed: int, num_paths: int, device) -> list:
    """The seed's weights as the program got them, in f32, flat."""
    return [weights.flat(t) for t in
            weights.make_paths(m, seed, num_paths, device, torch.float32)]


def train_readings(m: dict, mix: dict, seed: int, assign: np.ndarray,
                   device, precision: str = "f32") -> dict:
    """The reference's losses (steps, W), first-step gradient norms and
    sketches and outer-step change norms (per worker, per leaf), each
    worker on the documents ``assign`` gives it."""
    precise()
    docs = generator.corpus_documents(mix, m["vocab_size"], mix["docs"], seed)
    base = f32_params(m, seed, 1, device)[0]
    w_count = int(np.prod(mix["levels"]))
    shards = [docs[np.nonzero(assign == i)[0]] for i in range(w_count)]
    sizes = [len(s) for s in shards]
    steps = mix["check_steps"]
    lr = [train.lr_at(t, mix["peak_lr"], mix["warmup"], mix["total_steps"])
          for t in range(steps)]
    finals, losses, firsts, sketches = [], [], [], []
    for w, shard in enumerate(shards):
        rows = train.phase_rows(len(shard), mix["batch"], steps, w, 0)
        batches = torch.as_tensor(shard[rows], device=device)
        final, loss, first, proj = train.inner_steps(
            base, m, batches, precision=precision, lr=lr,
            micro=mix["reference_rows"], prefix_len=m["route_prefix_len"],
            seed=seed)
        finals.append(final)
        losses.append(loss)
        firsts.append(first)
        sketches.append(proj)
    changes = train.outer_changes(base, finals, mix["levels"], sizes,
                                  m["num_layers"])
    del finals
    return {"losses": np.asarray(losses).T, "grad_norms": firsts,
            "sketches": sketches, "changes": changes}


def train_numbers(got: dict, want: dict) -> dict:
    """The compared numbers of a training cell: ``got`` the program's
    (or the control's) readings, ``want`` the f32 reference's."""
    grad = max(compare.norm_gap(g, w)[0]
               for g, w in zip(got["grad_norms"], want["grad_norms"]))
    update = max(compare.norm_gap(g, w, compare.moving_leaves(wg))[0]
                 for g, w, wg in zip(got["changes"], want["changes"],
                                     want["grad_norms"]))
    errors = [compare.sketch_gaps(g, w, compare.moving_leaves(wg))
              for g, w, wg in zip(got["sketches"], want["sketches"],
                                  want["grad_norms"])]
    return {"loss_gap": compare.relative_gap(got["losses"], want["losses"]),
           "grad_gap": grad,
           "grad_error": max(max(e.values()) for e in errors),
           "grad_error_med": max(float(np.median(list(e.values())))
                                 for e in errors),
           "update_gap": update}


def served_gaps(m: dict, seed: int, num_paths: int, served: list,
                centroids: torch.Tensor, device,
                precision: str = "f32") -> dict:
    """``served``: (prompt, generated tokens, path) of finished requests.
    -> the widest gap by which a generated token's reference logit lies
    below the reference's best at its position (``logit_gap``), and the
    route's relative excess distance to the prefix features' nearest
    centroid (``route_gap``).  With ``precision="fp8"`` the token judged
    at each position is the one the fp8 reference puts first (the
    control)."""
    precise()
    paths = f32_params(m, seed, num_paths, device)
    ref = [build(p, m) for p in paths]
    low = [build(p, m, "fp8") for p in paths] if precision == "fp8" else None
    gap, route = 0.0, 0.0
    plen = m["route_prefix_len"]
    with torch.no_grad():
        for prompt, gen, path in served:
            seq = torch.as_tensor(np.concatenate([prompt, gen])[None, :-1],
                                  device=device)
            lg = ref[path].logits(seq)[0, len(prompt) - 1:]
            picked = torch.as_tensor(gen, device=device).long()
            if low is not None:
                picked = low[path].logits(seq)[0, len(prompt) - 1:].argmax(-1)
            best = lg.max(-1).values
            got = lg.gather(-1, picked[:, None])[:, 0]
            gap = max(gap, float((best - got).max()))
            z = ref[0].features(seq[:, :plen], plen)
            d2 = ((z - centroids.to(device).float()) ** 2).sum(-1)
            route = max(route, float((d2[path] - d2.min()) / d2.min()))
    return {"logit_gap": gap, "route_gap": route}
