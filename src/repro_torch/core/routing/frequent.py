"""Routing more frequently at test time (paper §2.4.3, Fig. 3, Table 3);
the port of ``repro/core/routing/frequent.py``.

A sequence is scored in chunks of ``every`` tokens; the router picks the
path for chunk i+1 from features of the previous chunk under the base LM
(the linear-router analogue of the paper's transducer router §7.2.2).

Implementation: per-token NLL is computed once per path for the whole
sequence (the same S_ijp tensor used by discriminative routing), then
chunk spans are mixed according to the per-chunk routing choice.  In a
deployment the switch would instead recompute the KV cache — the paper's
§6 limitation; FLOP cost is identical, this is just vectorized.

The router is anything with ``assign(z) -> (N,)`` path ids: a
``DiscriminativeRouter``, or a ``KMeansRouter``, whose assignment on the
card is the ``router_assign`` kernel (one launch a chunk).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import apply_lm, lm_loss

from .features import params_device


@torch.inference_mode()
def per_token_nll(path_params_list, cfg: ModelConfig, tokens,
                  batch_size: int = 32):
    """-> (P, N, S-1) per-token NLL for every path."""
    rows = []
    for params in path_params_list:
        tk_all = torch.as_tensor(tokens, device=params_device(params))
        outs = []
        for i in range(0, tk_all.shape[0], batch_size):
            tk = tk_all[i:i + batch_size]
            logits, _ = apply_lm(params, cfg, tk)
            outs.append(lm_loss(logits, tk, prefix_len=0)[0])
        rows.append(torch.cat(outs, 0))
    return torch.stack(rows, 0)


@torch.inference_mode()
def chunk_choices(router, feat_params, cfg: ModelConfig, tokens, *,
                  every: int, batch_size: int = 64):
    """Routing decision per chunk: chunk 0 uses the routing prefix; chunk
    i>0 uses features of chunk i-1.  -> ((N, num_chunks) int, chunk
    starts)."""
    tokens = torch.as_tensor(tokens, device=params_device(feat_params))
    n, s = tokens.shape
    prefix = cfg.route_prefix_len

    def batched_feats(tk):
        outs = []
        for i in range(0, n, batch_size):
            h, _ = apply_lm(feat_params, cfg, tk[i:i + batch_size],
                            return_hidden=True)
            outs.append(h.float().mean(dim=1))
        return torch.cat(outs, 0)

    starts = list(range(prefix, s, every))
    cols = []
    for ci, lo in enumerate(starts):
        if ci == 0:
            z = batched_feats(tokens[:, :prefix])
        else:
            z = batched_feats(tokens[:, max(0, lo - every):lo])
        cols.append(np.asarray(torch.as_tensor(router.assign(z)).cpu()))
    return np.stack(cols, 1), starts


def evaluate_rerouted(path_params_list, cfg: ModelConfig, router,
                      feat_params, tokens, *, every: int,
                      batch_size: int = 32) -> dict:
    """Mean NLL/token (excluding the routing prefix) with re-routing."""
    nll = per_token_nll(path_params_list, cfg, tokens,
                        batch_size).cpu().numpy()          # (P, N, S-1)
    choices, starts = chunk_choices(router, feat_params, cfg, tokens,
                                    every=every, batch_size=batch_size)
    n, s = np.shape(tokens)
    total, count, switches = 0.0, 0, 0
    for ci, lo in enumerate(starts):
        hi = min(lo + every, s)
        # targets at positions lo-1 .. hi-2 predict tokens lo .. hi-1
        span = slice(max(lo - 1, 0), hi - 1)
        for i in range(n):
            p = choices[i, ci]
            total += float(nll[p, i, span].sum())
        count += n * (span.stop - span.start)
        if ci > 0:
            switches += int((choices[:, ci] != choices[:, ci - 1]).sum())
    mean_nll = total / max(count, 1)
    return {"nll": mean_nll, "ppl": float(np.exp(mean_nll)),
            "switch_rate": switches / max(n * max(len(starts) - 1, 1), 1)}
