"""DiPaCo trainer (Algorithm 1) — stacked-worker simulation; the port of
``repro/core/dipaco.py``.

Every path is a row of a worker-stacked parameter tree; the inner phase
is ``tau`` AdamW steps per worker (zero cross-path communication by
construction), the outer phase applies the per-module DiLoCo mixing
(core/diloco.py).  With W == P this is exactly Algorithm 1.

Special cases (paper §2.6.3 / §4.3):
  flat MoE : DiPaCoConfig(levels=(P,), shared_embeddings=False)
  DiLoCo   : DiPaCoConfig(levels=(1,))  — all paths share one module
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.diloco import outer_state_init, outer_step_
from repro_torch.core.partition import make_partition, mixing_matrices
from repro_torch.data.loader import ShardLoader, phase_batches
from repro_torch.data.sharder import PreShardedDataset
from repro_torch.launch.steps import (make_inner_train_step,
                                      make_sync_train_step, row)
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig, ModelConfig
from repro_torch.models.lm import apply_lm, lm_loss
from repro_torch.models.params import param_axes, tree_leaves, tree_map
from repro_torch.optim import adamw_init, cosine_schedule


def stack_tree(tree, n: int):
    """n copies of every leaf, stacked on a new leading axis."""
    return tree_map(lambda x: x[None].repeat(n, *([1] * x.ndim)), tree)


@dataclass
class PhaseMetrics:
    """Per-phase result of a trainer: attribute access (``m.mean_loss``)
    and dict-style access (``m["outer_updates"]``), backend-specific
    counters riding in ``extra``."""
    mean_loss: float
    final_loss: float = math.nan
    per_path_loss: Optional[np.ndarray] = None
    extra: dict = field(default_factory=dict)

    def __getitem__(self, key):
        if key in self.extra:
            return self.extra[key]
        if key != "extra" and hasattr(self, key):
            return getattr(self, key)
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return (["mean_loss", "final_loss", "per_path_loss"]
                + list(self.extra))


class DiPaCoTrainer:
    def __init__(self, cfg: ModelConfig, dcfg: DiPaCoConfig,
                 dataset: PreShardedDataset, *, base_params=None,
                 batch_size: int = 8, peak_lr: float = 4e-4,
                 warmup: int = 100, total_steps: int = 10_000,
                 seed: int = 0, device="cuda"):
        self.cfg, self.dcfg = cfg, dcfg
        self.dataset = dataset
        self.batch_size = batch_size
        self.partition = make_partition(dcfg, cfg.pattern_repeats)
        P = self.partition.num_paths
        # workers >= paths: e.g. classic DiLoCo is P=1 path, W workers
        W = dataset.num_shards
        if not (W % P == 0 or P == 1):
            raise ValueError(f"{W} shards cannot host {P} paths evenly")
        self.num_workers = W
        self.worker_paths = np.arange(W) % P
        if base_params is None:
            base_params = api.init_model(cfg, seed=seed, device=device)
        self.device = tree_leaves(base_params)[0].device
        self.axes = param_axes(cfg)
        self.worker_params = stack_tree(base_params, W)
        self.global_params = stack_tree(
            tree_map(lambda x: x.float(), base_params), W)
        self.opt_state = stack_tree(adamw_init(base_params), W)
        self.outer_state = outer_state_init(self.global_params)
        alphas = dataset.alphas() if dcfg.loss_reweigh else None
        mixl, mixs = mixing_matrices(
            self.partition, self.worker_paths, alphas,
            grad_norm_rescale=dcfg.grad_norm_rescale)
        self.mix_layers = torch.as_tensor(mixl, device=self.device)
        self.mix_shared = torch.as_tensor(mixs, device=self.device)
        self.loaders = [ShardLoader(s, batch_size, seed=seed + i)
                        for i, s in enumerate(dataset.shards)]
        self.step = 0
        self.phase = 0
        self.lr = lambda t: cosine_schedule(
            t, peak_lr=peak_lr, warmup=warmup, total_steps=total_steps)
        self._step_fn = make_inner_train_step(cfg)
        # early stopping (paper §2.7)
        self.best_holdout = np.full(W, np.inf)
        self.best_params = None

    # ------------------------------------------------------------------
    @classmethod
    def resume(cls, cfg, dcfg, dataset, *, ckpt_root=None, **kw):
        """The in-memory trainer keeps no durable state to resume from;
        the checkpointed backends ("barrier", "service") and the mesh
        backend (phase-state files) do."""
        raise NotImplementedError(
            "DiPaCoTrainer is in-memory only and cannot resume; use "
            "make_trainer(..., backend='barrier'|'service'|'mesh')")

    # ------------------------------------------------------------------
    def _outer(self):
        d = self.dcfg
        outer_step_(self.worker_params, self.global_params, self.outer_state,
                    self.axes, self.mix_layers, self.mix_shared,
                    lr=d.outer_lr, momentum=d.outer_momentum,
                    nesterov=d.outer_nesterov)
        return self.worker_params, self.global_params, self.outer_state

    def run_phase(self, tau: Optional[int] = None) -> PhaseMetrics:
        tau = tau or self.dcfg.inner_steps
        batches = np.stack(
            [phase_batches(ld.tokens, ld.batch_size, tau, i, self.phase)
             for i, ld in enumerate(self.loaders)], axis=1)  # (tau, W, B, S)
        batches = torch.as_tensor(batches, device=self.device)
        losses = []
        for t in range(tau):
            lr = self.lr(self.step + t).to(self.device)
            self.worker_params, self.opt_state, metrics = self._step_fn(
                self.worker_params, self.opt_state, {"tokens": batches[t]},
                lr)
            losses.append(metrics["loss"])
        self.step += tau
        self.phase += 1
        self.worker_params, self.global_params, self.outer_state = \
            self._outer()
        losses = torch.stack(losses).float().cpu().numpy()   # (tau, W)
        if self.dcfg.early_stopping:
            self._early_stop_update()
        return PhaseMetrics(mean_loss=float(losses.mean()),
                            final_loss=float(losses[-1].mean()),
                            per_path_loss=losses[-1])

    # ------------------------------------------------------------------
    def _early_stop_update(self):
        hold = self.holdout_losses()
        if self.best_params is None:
            self.best_params = tree_map(torch.clone, self.worker_params)
            self.best_holdout = hold
            return
        mask = torch.as_tensor(hold < self.best_holdout, device=self.device)

        def sel(cur, best):
            m = mask.reshape((-1,) + (1,) * (cur.ndim - 1))
            return torch.where(m, cur, best)

        self.best_params = tree_map(sel, self.worker_params, self.best_params)
        self.best_holdout = np.minimum(hold, self.best_holdout)

    def holdout_losses(self) -> np.ndarray:
        out = np.zeros(self.num_workers)
        for i in range(self.num_workers):
            h = self.dataset.holdouts[i] if self.dataset.holdouts else None
            if h is None or len(h) == 0:
                out[i] = np.inf
                continue
            out[i] = self._eval_worker(i, h[:64])
        return out

    # ------------------------------------------------------------------
    def worker_of_path(self, p: int) -> int:
        return int(np.nonzero(self.worker_paths == p)[0][0])

    def path_params(self, i: int, *, best: bool = False):
        """Params of the first worker hosting path i."""
        src = self.best_params if (best and self.best_params is not None) \
            else self.worker_params
        return row(src, self.worker_of_path(i))

    def eval_path(self, i: int, tokens, *, best: bool = False,
                  batch_size: int = 32) -> float:
        return self._eval_worker(self.worker_of_path(i), tokens, best=best,
                                 batch_size=batch_size)

    def _eval_worker(self, w: int, tokens, *, best: bool = False,
                     batch_size: int = 32) -> float:
        src = self.best_params if (best and self.best_params is not None) \
            else self.worker_params
        return mean_nll(row(src, w), self.cfg, tokens, batch_size)

    def evaluate_routed(self, docs, assignments, *, best: bool = False):
        """PPL with docs routed to shards (route-once evaluation)."""
        return evaluate_routed(
            lambda p, d: self.eval_path(p, d, best=best), docs, assignments)


@torch.inference_mode()
def mean_nll(params, cfg: ModelConfig, tokens, batch_size: int = 32) -> float:
    """Mean NLL a token of ``tokens`` under ``params``, the routing prefix
    excluded."""
    device = tree_leaves(params)[0].device
    tokens = torch.as_tensor(tokens, device=device)
    tot = torch.zeros((), dtype=torch.float64, device=device)
    cnt = torch.zeros((), dtype=torch.float64, device=device)
    for j in range(0, len(tokens), batch_size):
        tk = tokens[j:j + batch_size]
        logits, _ = apply_lm(params, cfg, tk)
        nll, mask = lm_loss(logits, tk, cfg.route_prefix_len)
        tot += nll.sum().double()
        cnt += mask.sum().double()
    return float(tot) / max(float(cnt), 1.0)


def evaluate_routed(eval_path, docs, assignments) -> dict:
    """PPL with docs routed to paths (route-once evaluation);
    ``eval_path(p, docs)`` is path p's mean NLL on its docs."""
    assignments = np.asarray(assignments)
    tot, cnt = 0.0, 0
    for p in np.unique(assignments):
        idx = np.nonzero(assignments == p)[0]
        tot += eval_path(int(p), docs[idx]) * len(idx)
        cnt += len(idx)
    nll = tot / max(cnt, 1)
    return {"nll": nll, "ppl": float(np.exp(nll))}


class SyncDiPaCoTrainer(DiPaCoTrainer):
    """Fully-synchronous ablation (paper §4.5): per-STEP gradient mixing
    module-by-module (communicating tau x more often), then one AdamW
    step per worker.  Same mixing matrices, no outer optimizer."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # gradient mixing must be an unbiased average: no sqrt rescale
        mixl, mixs = mixing_matrices(
            self.partition, self.worker_paths,
            self.dataset.alphas() if self.dcfg.loss_reweigh else None,
            grad_norm_rescale=False)
        self._step_fn = make_sync_train_step(
            self.cfg, torch.as_tensor(mixl, device=self.device),
            torch.as_tensor(mixs, device=self.device), self.axes)

    def _outer(self):
        return self.worker_params, self.global_params, self.outer_state


def flat_moe_config(num_paths: int, **kw) -> DiPaCoConfig:
    """Flat MoE baseline (§2.6.3): one level, no sharing at all."""
    return DiPaCoConfig(levels=(num_paths,), shared_embeddings=False, **kw)


def diloco_config(num_workers: int, **kw) -> DiPaCoConfig:
    """Classic DiLoCo (§2.5): every worker trains the whole (single)
    module; paths collapse at every outer step."""
    return DiPaCoConfig(levels=(1,), shared_embeddings=True, **kw)
