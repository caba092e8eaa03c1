"""Path-serving engine (paper §2.2/§2.6: "at test time, the paths are
instantiated and served independently, with text routed to each path via
a router").

The port of the one-shot engine of ``repro/serving/engine.py``:
:class:`PathServingEngine` routes each request by its prefix features,
then runs greedy generation on the chosen path — the prompt replayed
through decode steps to build the cache, then one decode step per new
token — with optional §2.4.3 re-routing every ``reroute_every`` tokens.
Under ``cfg.attn_impl == "pallas"`` the routing features go through the
flash-attention kernel and every decode step through flash-decode.

The continuous-batching engine, the deployment registry and telemetry
are not ported yet (ROADMAP queue 1, items 1 and 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.routing.features import params_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import apply_lm


@dataclass
class EngineOptions:
    """Construction options of the serving engine (the one-shot subset
    of the reference's bag)."""

    router: Any = None
    route_fn: Any = None
    registry: Any = None
    cache_len: int = 512
    telemetry: Any = None

    def __post_init__(self):
        if self.router is not None and self.route_fn is not None:
            raise ValueError("pass either router (feature-based) or "
                             "route_fn (prompt -> path id), not both")
        if self.registry is not None:
            raise NotImplementedError(
                "registry= is not ported to repro_torch yet (ROADMAP "
                "queue 1, item 3: checkpoint and deploy planes)")
        if self.telemetry is not None:
            raise NotImplementedError(
                "telemetry= is not ported to repro_torch yet (ROADMAP "
                "queue 1, item 1: continuous engine and telemetry)")
        if self.cache_len < 1:
            raise ValueError(f"cache_len must be >= 1, "
                             f"got {self.cache_len}")


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, prompt + new)
    paths: np.ndarray           # (B,) final path per request
    switches: int


class _EngineBase:
    """Shared routing / feature plumbing."""

    def __init__(self, cfg: ModelConfig, path_params_list, *,
                 options: Optional[EngineOptions] = None):
        if not path_params_list:
            raise ValueError("path_params_list is required")
        opts = options if options is not None else EngineOptions()
        self.cfg = cfg
        self.options = opts
        self.paths = list(path_params_list)
        self.device = params_device(self.paths[0])
        self.router = opts.router
        self.route_fn = opts.route_fn
        self.cache_len = opts.cache_len
        # routing features come from the first path (the base LM)
        self._feat_src = self.paths[0]

    @torch.inference_mode()
    def _feats(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device)
        h, _ = apply_lm(self._feat_src, self.cfg, tokens, return_hidden=True)
        return h.float().mean(dim=1)

    def route(self, tokens) -> np.ndarray:
        if self.route_fn is not None:
            return np.asarray([self.route_fn(t) for t in tokens], np.int32)
        if self.router is None:
            return np.zeros(tokens.shape[0], np.int32)
        z = self._feats(tokens[:, :self.cfg.route_prefix_len])
        return self.router.assign(z).cpu().numpy().astype(np.int32)


class PathServingEngine(_EngineBase):
    """One-shot batch engine: synchronous generate per batch."""

    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _decode(self, params, tok, cache, idx):
        logits, cache = api.serve_step(params, self.cfg, {"tokens": tok},
                                       cache, idx)
        return logits[:, 0], cache

    def _build_cache(self, params, tokens):
        """Prefill by replaying tokens through decode steps."""
        b, s = tokens.shape
        cache = api.init_serve_cache(self.cfg, b, self.cache_len,
                                     device=self.device)
        logits = None
        for t in range(s):
            logits, cache = self._decode(params, tokens[:, t:t + 1], cache, t)
        return logits, cache

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int, *,
                 reroute_every: int = 0) -> GenerationResult:
        """Greedy generation.  With ``reroute_every`` a whole co-routed
        group follows the first request's re-route vote, as in the
        reference."""
        prompts = np.asarray(prompts)
        b, s0 = prompts.shape
        assign = self.route(prompts)
        switches = 0
        results = np.zeros((b, s0 + max_new), np.int32)
        results[:, :s0] = prompts
        final_paths = np.asarray(assign).copy()
        for p in np.unique(assign):
            sel = np.nonzero(assign == p)[0]
            params = self.paths[int(p)]
            # logits predicts the token at position `pos`
            logits, cache = self._build_cache(
                params, self._tokens(results[sel, :s0]))
            cur_path = int(p)
            pos = s0
            for t in range(max_new):
                nxt = torch.argmax(logits, dim=-1)     # greedy
                results[sel, pos] = nxt.cpu().numpy()
                if (reroute_every and (t + 1) % reroute_every == 0
                        and self.router is not None and t + 1 < max_new):
                    z = self._feats(
                        results[sel, max(0, pos - reroute_every + 1):pos + 1])
                    new_p = int(self.router.assign(z)[0])
                    if new_p != cur_path:
                        switches += 1
                        cur_path = new_p
                        params = self.paths[new_p]
                        # §6 limitation: rebuild the cache on the new path
                        logits, cache = self._build_cache(
                            params, self._tokens(results[sel, :pos + 1]))
                        pos += 1
                        continue
                logits, cache = self._decode(
                    params, self._tokens(results[sel, pos:pos + 1]), cache,
                    pos)
                pos += 1
            final_paths[sel] = cur_path
        return GenerationResult(tokens=results, paths=final_paths,
                                switches=switches)
