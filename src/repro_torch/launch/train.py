"""Training launcher of the port, and the streaming mesh trainer.

The launcher runs the quickstart pipeline corpus -> prefix features ->
k-means -> pre-sharding -> DiLoCo-per-module phases -> routed
evaluation, through ``make_trainer(backend=...)``.

    # dipaco-150m at full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --levels 2x2 \
        --phases 2 --tau 10

    # the §3 service: 4 pool threads, staleness window 1, int8 wire
    PYTHONPATH=src python -m repro_torch.launch.train --backend service \
        --num-workers 4 --max-phase-lag 1 --comm-dtype int8 --fragments 4

    # the streaming fragment schedule over two processes (one card each,
    # NCCL; ranks that share a card, or the CPU, run gloo)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --backend mesh --fragments 2 --comm-dtype int8

    # the smoke config on the CPU (plain attention and k-means, no kernels)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke

Every backend of ``repro.launch.train`` is ported, with the reference's
fault (``--transport-retries``, ``--fault-*``), fleet (``--profile``)
and chaos (``--chaos-kill-frac``, ``--chaos-phase``) flags.

``MeshStreamingTrainer`` is the ``backend="mesh"`` trainer: the vector
trainer's semantics with the phase split into K segments and each
fragment's outer reduce gathered across the ranks of a worker mesh
(``launch/mesh.py``, ``launch/steps.py``) while the next segment
computes.
"""
from __future__ import annotations

import argparse
import glob
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import pytree
from repro_torch.core.diloco import fragment_state_init
from repro_torch.core.dipaco import (PhaseMetrics, evaluate_routed, mean_nll,
                                     stack_tree)
from repro_torch.core.fragments import FragmentSpec, segment_bounds
from repro_torch.core.partition import make_partition, mixing_matrices
from repro_torch.core.routing import kmeans_assign, kmeans_fit, prefix_features
from repro_torch.data import SyntheticCorpus, shard_documents
from repro_torch.data.loader import ShardLoader, phase_batches
from repro_torch.device import resolve_device
from repro_torch.infra.ckpt_db import load_tree, save_tree
from repro_torch.launch.mesh import make_worker_mesh, world_backend
from repro_torch.launch.steps import make_streaming_mesh_phase, row
from repro_torch.models import api
from repro_torch.models.config import DiPaCoConfig, ModelConfig
from repro_torch.models.params import param_axes
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.training import make_trainer


class MeshStreamingTrainer:
    """Streaming fragment-wise DiPaCo over the ranks of a worker mesh.

    The same math as ``core.diloco.segmented_streaming_phase`` (bit-exact,
    tests/test_torch_mesh.py).  Each rank holds its own rows
    (``mesh.rows``) of the worker params, the f32 global copies, the
    AdamW state, the fragment Nesterov states and the wire residuals,
    and loads only its own shards (``phase_batches`` is a pure function
    of the shard and the phase).  Fragment reduces gather every rank's
    rows and overlap the next segment's inner compute.  With
    ``dcfg.outer_fragments == 1`` the schedule is classic burst DiLoCo
    through the same code path.

    ``ckpt_root`` (optional) enables phase-granular checkpointing: rank
    0 writes the whole trainer state, gathered from every rank, after
    every phase, and ``resume`` continues bit-exactly.  The file's layout
    is the reference's, so a file written by either package resumes in
    the other (with f32 weights: the reference reads no bfloat16 file).

    ``run_phase`` and ``path_params`` are collective: every rank of the
    mesh calls them, in the same order.
    """

    def __init__(self, cfg: ModelConfig, dcfg: DiPaCoConfig, dataset, *,
                 ckpt_root: Optional[str] = None, base_params=None,
                 batch_size: int = 8, peak_lr: float = 4e-4,
                 warmup: int = 100, total_steps: int = 10_000,
                 seed: int = 0, device="cuda", mesh=None):
        self.cfg, self.dcfg = cfg, dcfg
        self.dataset = dataset
        self.batch_size = batch_size
        self.ckpt_root = ckpt_root
        self.partition = make_partition(dcfg, cfg.pattern_repeats)
        P = self.partition.num_paths
        W = dataset.num_shards
        if not (W % P == 0 or P == 1):
            raise ValueError(f"num_shards {W} not a multiple of paths {P}")
        self.num_workers = W
        self.worker_paths = np.arange(W) % P
        self.mesh = mesh if mesh is not None else make_worker_mesh(
            W, device=device)
        if self.mesh.num_workers != W:
            raise ValueError(f"the mesh holds {self.mesh.num_workers} "
                             f"workers, the dataset {W} shards")
        self.device = dev = self.mesh.device
        self.rows = self.mesh.rows
        if base_params is None:
            base_params = api.init_model(cfg, seed=seed, device=dev)
        else:
            base_params = pytree.tree_map(lambda x: x.to(dev), base_params)
        self.axes = param_axes(cfg)
        n = len(self.rows)
        self.worker_params = stack_tree(base_params, n)
        self.global_params = stack_tree(
            pytree.tree_map(lambda x: x.float(), base_params), n)
        self.opt_state = stack_tree(adamw_init(base_params), n)
        self.fragspec = FragmentSpec(self.global_params,
                                     dcfg.outer_fragments)
        self.frag_states = fragment_state_init(self.global_params,
                                               self.fragspec)
        self.residuals: dict = {}
        # per-worker byte accounting on the unstacked leaf layout (the
        # stacked spec's fragments cover the same leaves, x W rows)
        self._row_spec = FragmentSpec(base_params, dcfg.outer_fragments)
        self.comm_stats = {"peak_sync_bytes": 0, "total_comm_bytes": 0,
                           "sends": 0}
        alphas = dataset.alphas() if dcfg.loss_reweigh else None
        mixl, mixs = mixing_matrices(
            self.partition, self.worker_paths, alphas,
            grad_norm_rescale=dcfg.grad_norm_rescale)
        self.mix_layers = torch.as_tensor(mixl, device=dev)
        self.mix_shared = torch.as_tensor(mixs, device=dev)
        self.loaders = {i: ShardLoader(dataset.shards[i], batch_size,
                                       seed=seed + i) for i in self.rows}
        self.step = 0
        self.phase = 0
        self.lr = lambda t: cosine_schedule(
            t, peak_lr=peak_lr, warmup=warmup, total_steps=total_steps)
        self._phase_fn = make_streaming_mesh_phase(
            cfg, self.mesh, self.axes, self.fragspec,
            comm_dtype=dcfg.comm_dtype, outer_lr=dcfg.outer_lr,
            outer_momentum=dcfg.outer_momentum,
            outer_nesterov=dcfg.outer_nesterov)

    # ------------------------------------------------------------------
    @classmethod
    def resume(cls, cfg, dcfg, dataset, *, ckpt_root, **kw):
        """Rebuild from the newest phase-state file under ``ckpt_root``
        (no-op construction if none exists yet).  Same constructor
        arguments as the original run; each rank reads its own rows."""
        self = cls(cfg, dcfg, dataset, ckpt_root=ckpt_root, **kw)
        files = sorted(glob.glob(
            os.path.join(ckpt_root, "mesh_phase_*.npz")))
        if not files:
            return self
        # the whole tree's shapes and dtypes, on the host, to check the
        # file against; only this rank's rows go to the device
        W = self.num_workers
        like = pytree.tree_map(
            lambda x: torch.empty((W, *x.shape[1:]), dtype=x.dtype),
            self._local_tree())
        if dcfg.comm_dtype != "fp32":
            # after one full phase every leaf carries a residual
            like["residuals"] = {
                i: torch.empty((W, *x.shape[1:]), dtype=torch.float32)
                for i, x in enumerate(
                    self.fragspec.flatten(self.global_params))}
        like["meta"] = self._meta()
        state = load_tree(files[-1], like)
        rows = slice(self.rows.start, self.rows.stop)
        mine = pytree.tree_map(lambda x: x[rows].to(self.device, copy=True),
                               {k: state[k] for k in like if k != "meta"})
        self.worker_params = mine["worker"]
        self.global_params = mine["global"]
        self.opt_state = mine["opt"]
        self.frag_states = mine["frag_states"]
        self.residuals = mine["residuals"]
        self.step = int(state["meta"]["step"])
        self.phase = int(state["meta"]["phase"])
        self.comm_stats = {k: int(v)
                           for k, v in state["meta"]["comm"].items()}
        return self

    def _local_tree(self) -> dict:
        return {"worker": self.worker_params,
                "global": self.global_params,
                "opt": self.opt_state,
                "frag_states": self.frag_states,
                "residuals": self.residuals}

    def _meta(self) -> dict:
        return {"step": np.int64(self.step), "phase": np.int64(self.phase),
                "comm": {k: np.int64(v) for k, v in self.comm_stats.items()}}

    def _gather_rows(self, x, *, to_all: bool = False):
        """Every rank's rows of ``x``, in rank order, on rank 0 (on every
        rank with ``to_all``); ``None`` on the other ranks."""
        m = self.mesh
        if m.world == 1:
            return x
        x = x.contiguous()
        if to_all:
            chunks = [torch.empty_like(x) for _ in range(m.world)]
            dist.all_gather(chunks, x, group=m.group)
            return torch.cat(chunks, 0)
        chunks = ([torch.empty_like(x) for _ in range(m.world)]
                  if m.rank == 0 else None)
        dist.gather(x, chunks, dst=0, group=m.group)
        return torch.cat(chunks, 0) if m.rank == 0 else None

    def _save_phase(self):
        """Rank 0 writes the whole state (the reference's layout); every
        rank waits for the write."""
        full = pytree.tree_map(self._gather_rows, self._local_tree())
        if self.mesh.rank == 0:
            full["meta"] = self._meta()
            save_tree(os.path.join(self.ckpt_root,
                                   f"mesh_phase_{self.phase:06d}.npz"),
                      full)
        del full
        if self.mesh.world > 1:
            dist.barrier(group=self.mesh.group)

    # ------------------------------------------------------------------
    def run_phase(self, tau: Optional[int] = None) -> PhaseMetrics:
        tau = tau or self.dcfg.inner_steps
        K = self.fragspec.num_fragments
        bounds = segment_bounds(tau, K)
        batches = torch.as_tensor(np.stack(
            [phase_batches(self.loaders[i].tokens, self.batch_size, tau, i,
                           self.phase) for i in self.rows], axis=1),
            device=self.device)                       # (tau, W_local, B, T)
        lrs = torch.stack([self.lr(self.step + t) for t in range(tau)]
                          ).to(self.device)
        seg_batches = [batches[bounds[s]:bounds[s + 1]] for s in range(K)]
        seg_lrs = [lrs[bounds[s]:bounds[s + 1]] for s in range(K)]
        (self.worker_params, self.opt_state, self.global_params,
         self.frag_states, self.residuals, losses) = self._phase_fn(
            self.worker_params, self.opt_state, self.global_params,
            self.frag_states, self.residuals, self.mix_layers,
            self.mix_shared, seg_batches, seg_lrs)
        losses = self._gather_rows(losses.float().T.contiguous(),
                                   to_all=True).T      # (tau, W)
        self.step += tau
        self.phase += 1
        # one send instant per fragment per worker; peak = the largest
        # single instant (burst K=1: the whole tree at once)
        frag_bytes = [self._row_spec.wire_bytes(f, self.dcfg.comm_dtype)
                      for f in range(K)]
        self.comm_stats["sends"] += K * self.num_workers
        self.comm_stats["total_comm_bytes"] += \
            sum(frag_bytes) * self.num_workers
        self.comm_stats["peak_sync_bytes"] = max(
            self.comm_stats["peak_sync_bytes"], max(frag_bytes))
        if self.ckpt_root:
            self._save_phase()
        losses = losses.cpu().numpy()
        return PhaseMetrics(
            mean_loss=float(losses.mean()),
            final_loss=float(losses[-1].mean()),
            per_path_loss=losses[-1],
            extra={"outer_updates": K,
                   "comm": dict(self.comm_stats)})

    # ------------------------------------------------------------------
    def worker_of_path(self, p: int) -> int:
        return int(np.nonzero(self.worker_paths == p)[0][0])

    def path_params(self, i: int):
        """Params of the first worker hosting path ``i``.  Collective:
        every rank calls it, the rank holding that worker broadcasts its
        row, and every rank returns the same tree."""
        w = self.worker_of_path(i)
        m = self.mesh
        if m.world == 1:
            return row(self.worker_params, w)
        owner = w // m.rows_per_rank
        local = w - self.rows.start

        def bcast(x):
            t = (x[local].contiguous() if m.rank == owner
                 else torch.empty(x.shape[1:], dtype=x.dtype,
                                  device=x.device))
            dist.broadcast(t, src=owner, group=m.group)
            return t

        return pytree.tree_map(bcast, self.worker_params)


def _parse_profiles(specs):
    """``SHARD:BANDWIDTH[:COMPUTE[:PREEMPT]]`` -> {shard: WorkerProfile}."""
    from repro_torch.infra.fleet import WorkerProfile
    profiles = {}
    for spec in specs:
        parts = spec.split(":")
        if not 2 <= len(parts) <= 4:
            raise SystemExit(f"bad --profile {spec!r}: expected "
                             "SHARD:BANDWIDTH[:COMPUTE[:PREEMPT]]")
        shard = int(parts[0])
        nums = [float(x) for x in parts[1:]]
        profiles[shard] = WorkerProfile(
            bandwidth=nums[0],
            compute=nums[1] if len(nums) > 1 else 1.0,
            preempt_rate=nums[2] if len(nums) > 2 else 0.0)
    return profiles


def _join_launched_world(device: torch.device) -> torch.device:
    """Under ``torchrun`` (``WORLD_SIZE`` set): join its ``env://`` world
    and return this rank's device (its own card where there are enough,
    else the cards shared round-robin, on gloo)."""
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local % torch.cuda.device_count())
    dist.init_process_group(world_backend(device, world),
                            init_method="env://")
    return device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dipaco-150m")
    ap.add_argument("--levels", default="2x2")
    ap.add_argument("--phases", type=int, default=2)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--docs", type=int, default=512)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of --arch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda; it "
                         "raises where there is no card)")
    ap.add_argument("--backend", default="vector",
                    choices=("vector", "mesh", "barrier", "service"),
                    help="trainer backend (repro_torch.make_trainer); "
                         "'mesh' runs the streaming fragment schedule "
                         "through collectives over the ranks (a world of "
                         "one, or torchrun's); 'service'/'barrier' run "
                         "the checkpointed worker-pool infrastructure")
    ap.add_argument("--ckpt-root", default=None,
                    help="CheckpointDB root for service/barrier (and "
                         "optional mesh phase-state files); a temporary "
                         "directory is created for service/barrier when "
                         "omitted")
    ap.add_argument("--num-workers", type=int, default=4,
                    help="pool threads for --backend service/barrier")
    ap.add_argument("--max-phase-lag", type=int, default=1,
                    help="staleness window for --backend service")
    ap.add_argument("--fragments", type=int, default=1,
                    help="outer fragments K (streaming sync)")
    ap.add_argument("--comm-dtype", default="fp32",
                    choices=("fp32", "int8", "int4"))
    ap.add_argument("--comm-dtype-policy", default="uniform",
                    choices=("uniform", "leafwise"),
                    help="'leafwise' quantizes large matmul leaves hard "
                         "(int4) but keeps norms/embeddings in fp32")
    ap.add_argument("--transport-retries", type=int, default=0,
                    help="per-send retry budget (exponential backoff) "
                         "for the service transport")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="deterministic fault-injection seed")
    ap.add_argument("--fault-drop", type=float, default=0.0)
    ap.add_argument("--fault-dup", type=float, default=0.0)
    ap.add_argument("--fault-corrupt", type=float, default=0.0)
    ap.add_argument("--fault-delay", type=float, default=0.0)
    ap.add_argument("--fault-delay-s", type=float, default=0.01,
                    help="injected delay duration per delayed send")
    ap.add_argument("--profile", action="append", default=[],
                    metavar="SHARD:BW[:COMPUTE[:PREEMPT]]",
                    help="per-worker fleet profile (repeatable); "
                         "bandwidth < 1 re-ranks that worker's fragment "
                         "sends smallest-first")
    ap.add_argument("--chaos-kill-frac", type=float, default=0.0,
                    help="service backend: evict this fraction of the "
                         "fleet mid-phase, then rejoin it for the last "
                         "phase (ChaosController)")
    ap.add_argument("--chaos-phase", type=int, default=1,
                    help="phase at which --chaos-kill-frac fires")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    launched = (args.backend == "mesh" and "WORLD_SIZE" in os.environ
                and not dist.is_initialized())
    if launched:
        device = _join_launched_world(device)
    rank = dist.get_rank() if dist.is_initialized() else 0

    def say(*a, **k):
        if rank == 0:
            print(*a, **k)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(route_prefix_len=8)
    api.check_decoder(cfg)
    if device.type == "cuda":
        cfg = cfg.replace(attn_impl="pallas")
    levels = tuple(int(x) for x in args.levels.split("x"))
    P = int(np.prod(levels))
    say(f"[launch] arch={cfg.name} smoke={args.smoke} levels={levels} "
        f"paths={P} device={device}")

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size,
                             num_domains=max(8, P), seq_len=args.seq, seed=0)
    docs = corpus.sample_documents(args.docs)
    val = corpus.sample_documents(max(args.docs // 8, P), seed=99)
    base = api.init_model(cfg, seed=0, device=device)
    feats = prefix_features(base, cfg, docs)
    gen = torch.Generator(device=device).manual_seed(1)
    cents, assign, _ = kmeans_fit(feats, P, generator=gen)
    ds = shard_documents(docs, assign.cpu().numpy(), P)
    say(f"[launch] shard sizes {ds.sizes.tolist()}")

    faults = None
    rates = {"drop": args.fault_drop, "dup": args.fault_dup,
             "corrupt": args.fault_corrupt, "delay": args.fault_delay}
    if any(v > 0 for v in rates.values()):
        faults = {"seed": args.fault_seed, "delay_s": args.fault_delay_s,
                  **rates}
    dcfg = DiPaCoConfig(levels=levels, inner_steps=args.tau,
                        outer_fragments=args.fragments,
                        comm_dtype=args.comm_dtype,
                        comm_dtype_policy=args.comm_dtype_policy,
                        transport_retries=args.transport_retries,
                        transport_faults=faults)
    kw: dict = {}
    pooled = args.backend in ("barrier", "service")
    if pooled:
        kw["ckpt_root"] = args.ckpt_root or tempfile.mkdtemp(
            prefix="dipaco-ckpt-")
        kw["num_workers"] = args.num_workers
        say(f"[launch] backend={args.backend} ckpt_root={kw['ckpt_root']}")
        if args.profile:
            kw["profiles"] = _parse_profiles(args.profile)
        if args.backend == "service":
            kw["max_phase_lag"] = args.max_phase_lag
    elif args.backend == "mesh":
        kw["ckpt_root"] = args.ckpt_root
    tr = make_trainer(cfg, dcfg, ds, backend=args.backend, device=device,
                      base_params=base, batch_size=args.batch_size,
                      peak_lr=2e-3, warmup=args.tau,
                      total_steps=args.phases * args.tau, **kw)
    t0 = time.time()
    losses = []
    try:
        if args.backend == "service" and args.chaos_kill_frac > 0:
            # scripted elasticity: kill a fleet fraction mid-phase, let
            # the survivors train with resized quorums, rejoin the
            # victims before the final phase
            from repro_torch.infra import ChaosController
            events = [{"phase": args.chaos_phase, "action": "kill_frac",
                       "frac": args.chaos_kill_frac, "when": "mid"}]
            chaos = ChaosController(tr, events, seed=args.fault_seed)
            m = chaos.run(max(args.phases - 1, 1), tau=args.tau)
            losses.append(m["mean_loss"])
            say(f"[chaos] events={m['chaos_events']} "
                f"epoch={m['fleet_epoch']} members={m['members']}")
            evicted = sorted(set(range(tr.num_shards)) - tr.members)
            if evicted:
                tr.fleet.join(evicted)
                say(f"[chaos] rejoined {evicted}")
            m = tr.run(1, tau=args.tau)
            losses.append(m["mean_loss"])
            say(f"[final] mean_loss {m['mean_loss']:.4f} "
                f"members={len(m['members'])} "
                f"epoch={m['fleet_epoch']} transport={m['transport']} "
                f"({time.time() - t0:.1f}s)")
        else:
            for ph in range(args.phases):
                if args.backend == "service":
                    loss = tr.run(1)["mean_loss"]     # pipelined, no barrier
                else:
                    loss = tr.run_phase().mean_loss
                losses.append(loss)
                say(f"[phase {ph}] loss {loss:.4f} "
                    f"({time.time() - t0:.1f}s)")
        if args.backend == "service":
            say(f"[comm] {tr.comm_stats()}")
        elif args.backend == "mesh":
            say(f"[comm] {tr.comm_stats}")
        va, _ = kmeans_assign(prefix_features(base, cfg, val), cents)
        res = evaluate_routed(
            lambda p, d: mean_nll(tr.path_params(p), cfg, d), val,
            va.cpu().numpy())
    finally:
        if pooled:
            tr.shutdown()
        if launched:
            dist.destroy_process_group()
    say(f"[eval] routed validation PPL {res['ppl']:.2f}")
    say("[done]")
    return {"phase_loss": losses, **res}


if __name__ == "__main__":
    main()
