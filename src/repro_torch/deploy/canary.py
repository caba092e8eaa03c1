"""Canary gate: score a candidate version against the serving version
on a held-out shadow trace before (and after) promotion; the port of
``repro/deploy/canary.py``.

Scoring is teacher-forced and deterministic: each shadow document is
assigned to one path (round-robin by default, or the deployment's
router via ``route_fn``) and scored with a single forward pass under
``torch.no_grad`` (under ``cfg.attn_impl == "pallas"`` its attention is
the flash-attention kernel on the card) —

 * **perplexity** of the candidate vs the serving version on the same
   documents (quality must not regress beyond ``ppl_ratio_tol``), and
 * **greedy-token agreement**: the fraction of positions where the
   candidate's argmax next-token prediction matches the serving
   version's (a training step legitimately moves some tokens, so the
   threshold is a floor, not an equality check).

The gate is pure scoring — promotion, rejection and rollback decisions
live in deploy/publisher.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.routing.features import params_device
from repro_torch.models import api
from repro_torch.models.lm import lm_loss_mean


@dataclass(frozen=True)
class CanaryReport:
    ppl_candidate: float
    ppl_serving: float
    agreement: float             # greedy-token agreement vs serving
    passed: bool
    reason: str = ""


class CanaryGate:
    def __init__(self, cfg, shadow_tokens, *, route_fn=None,
                 ppl_ratio_tol: float = 1.05, min_agreement: float = 0.8):
        """shadow_tokens: (N, S) int32 held-out documents (the shadow
        trace).  route_fn: prompt -> path id; round-robin when None."""
        self.cfg = cfg
        self.shadow = np.asarray(shadow_tokens, np.int32)
        if self.shadow.ndim != 2 or not len(self.shadow):
            raise ValueError(
                f"shadow trace must be (N, S), got {self.shadow.shape}")
        self.route_fn = route_fn
        self.ppl_ratio_tol = ppl_ratio_tol
        self.min_agreement = min_agreement
        self._assign_cache: dict = {}
        # version-score memo keyed by the identity of the path list: the
        # registry memoizes materialized versions, so the serving list is
        # the same object across publish cycles.  Entries hold a strong
        # reference to the keyed list (its id stays valid); bounded so
        # superseded versions are not pinned in memory.
        self._score_memo: dict = {}
        self._score_memo_cap = 4

    @torch.no_grad()
    def _score(self, params, toks: np.ndarray) -> tuple:
        """-> (mean NLL, greedy next-token ids (n, S) int32)."""
        tokens = torch.as_tensor(toks, device=params_device(params))
        logits, _ = api.forward_logits(params, self.cfg, {"tokens": tokens})
        nll = lm_loss_mean(logits, tokens, self.cfg.route_prefix_len)
        pred = torch.argmax(logits, dim=-1).to(torch.int32)
        return float(nll), pred.cpu().numpy()

    def _assignments(self, num_paths: int) -> np.ndarray:
        a = self._assign_cache.get(num_paths)
        if a is None:
            if self.route_fn is None:
                a = np.arange(len(self.shadow)) % num_paths
            else:
                a = np.asarray([int(self.route_fn(doc))
                                for doc in self.shadow])
            self._assign_cache[num_paths] = a
        return a

    def score(self, path_params_list) -> dict:
        """Per-version score: mean NLL / perplexity over the shadow
        trace plus the greedy next-token predictions (for agreement)."""
        assign = self._assignments(len(path_params_list))
        nll_sum, n_docs = 0.0, 0
        preds = np.zeros(self.shadow.shape, np.int32)
        for p in range(len(path_params_list)):
            idx = np.nonzero(assign == p)[0]
            if not len(idx):
                continue
            nll, pred = self._score(path_params_list[p], self.shadow[idx])
            nll_sum += nll * len(idx)
            n_docs += len(idx)
            preds[idx] = pred
        nll = nll_sum / max(n_docs, 1)
        with np.errstate(over="ignore"):     # inf ppl = gated regression
            ppl = float(np.exp(nll))
        return {"nll": nll, "ppl": ppl, "preds": preds}

    def _score_cached(self, path_params_list) -> dict:
        hit = self._score_memo.get(id(path_params_list))
        if hit is not None and hit[0] is path_params_list:
            return hit[1]
        s = self.score(path_params_list)
        while len(self._score_memo) >= self._score_memo_cap:
            del self._score_memo[next(iter(self._score_memo))]
        self._score_memo[id(path_params_list)] = (path_params_list, s)
        return s

    def evaluate(self, candidate_paths, serving_paths) -> CanaryReport:
        """Gate a candidate against the currently serving version."""
        cand = self._score_cached(candidate_paths)
        serv = self._score_cached(serving_paths)
        agreement = float(np.mean(cand["preds"] == serv["preds"]))
        if not np.isfinite(cand["ppl"]):
            return CanaryReport(cand["ppl"], serv["ppl"], agreement, False,
                                "candidate perplexity is not finite")
        if cand["ppl"] > serv["ppl"] * self.ppl_ratio_tol:
            return CanaryReport(
                cand["ppl"], serv["ppl"], agreement, False,
                f"perplexity regression: {cand['ppl']:.4f} > "
                f"{serv['ppl']:.4f} * {self.ppl_ratio_tol}")
        if agreement < self.min_agreement:
            return CanaryReport(
                cand["ppl"], serv["ppl"], agreement, False,
                f"greedy agreement {agreement:.3f} < {self.min_agreement}")
        return CanaryReport(cand["ppl"], serv["ppl"], agreement, True)
