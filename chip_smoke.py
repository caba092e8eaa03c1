#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. Card and build: prints the card's name and power limit, builds every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, in parallel) and prints the build time and ptxas's report
   (each entry function's registers, shared memory, spills), and the
   attention backward's registers and spill bytes by instantiation: the
   bf16 ones at head_dim 192 and 256 must not spill.  The machine code of the sources with a tensor-core path (``moe_gmm``,
   ``flash_attention``, ``flash_attention_bwd``, ``router_assign``,
   ``ssd_scan``, ``ssd_scan_bwd``) must hold wgmma (HGMMA) and TMA loads
   (UTMALDG).  Prints flash decode's dynamic shared memory a block for
   every head dim, cache dtype and head-group size, each within the
   232,448 bytes a block may take.
2. Kernels against their plain PyTorch versions on the card, in bf16 and
   f32, at the main paths' shapes and at others: flash attention and
   flash decode (serving), the forward that writes the LSE rows, the
   dK/dV and dQ backward kernels and the k-means assignment (training),
   the SSD scan (Mamba2, with its final state and chunk-start states)
   and its backward, and the expert GEMM (token MoE) and its dX and dW.
   Times each kernel, its plain version and one PyTorch call as a
   yardstick where one computes the same function.  Ragged shapes reach
   each edge of the tensor-core tilings; two launches of each backward
   kernel on the same inputs must give the same bits.
3. Serving at full width: ``dipaco-150m`` (12 blocks, d 896, vocab
   32000) in bf16 with ``attn_impl="pallas"``, 4 random paths and a
   discriminative router; ``PathServingEngine.generate`` serves 8 corpus
   prompts, once plain and once with re-routing, and must launch both
   serving kernels.  ``prefill`` + decode through the kernels is
   compared with the same calls through the plain attention.
4. Training at full width: the quickstart pipeline on ``dipaco-150m``
   (bf16, ``attn_impl="pallas"``, routing prefix 32): 2048 synthetic
   documents of 1024 tokens -> prefix features -> k-means (K = 4) ->
   pre-sharding -> ``make_trainer(backend="vector")`` for a 2x2 DiPaCo
   (4 paths, 4 workers, batch 8 per worker), 2 phases of 4 inner steps
   -> routed evaluation, and frequent-token routing beside it
   (``evaluate_rerouted``: the 64 validation documents re-routed every 64
   tokens by the k-means router; both losses printed, ``router_assign``
   launched once a chunk).  The loss must be finite and fall; every
   training kernel must launch as often as the path needs it.  One inner
   step's gradients through the kernels are compared with the plain
   attention's, leaf by leaf, in f32 and bf16.  Then the dry-run
   (``repro_torch.launch.dryrun.run_case``) of ``dipaco-150m`` at the
   four input shapes on the 16x16 logical mesh, on meta tensors under a
   fake process group (nothing on the card), each record printed and
   ``ok``; phase 4's worker step time beside the share of the H100's
   bf16 peak it reaches by the analytic ``total_flops`` of that step
   (B8 S1024, remat) and by ``model_flops`` (6 N D); and one worker's
   parameters + AdamW state as the meta trees predict them beside the
   step's measured resident and peak memory.
5. Serving the SSM and token-MoE families at full width and half their
   depth, in bf16 with ``attn_impl="pallas"``: ``mamba2-1.3b`` (24 of
   its 48 Mamba2 blocks, 4 paths) and ``qwen2-moe-a2.7b`` (12 of its 24
   blocks of attention and 60 experts top-4 plus 4 shared, 2 paths of
   about 14 GB), each as phase 3
   serves: a discriminative router over path 0's prefix features, 8
   prompts of 64 tokens, 16 new tokens, plain and re-routed.  Every
   decode step must be finite, and every kernel of the path must launch
   as often as its blocks need it.  Then ``prefill`` and 16 decode steps
   through the kernels against the plain path, in f32 and bf16.

6. Training the SSM and token-MoE families at full width, in bf16 with
   ``attn_impl="pallas"`` and remat ``"full"``: ``make_trainer(backend=
   "vector")`` on synthetic documents of 1024 tokens, 2 phases of 2 inner
   steps, for ``mamba2-1.3b`` as a 2-path flat DiPaCo at 24 of its 48
   blocks (batch 4 a worker; the inner and outer steps update the
   trainer's state in place; the peak allocated memory is printed beside
   the 24-block run's under the functional step, and running out of memory
   prints what holds it and fails) and ``qwen2-moe-a2.7b`` cut to 2 of its
   24 blocks, one worker (batch 4).  Each phase's mean loss must be
   finite and fall;
   the SSD scan and its backward, the expert GEMM and its dX and dW, and
   the attention's LSE forward, dK/dV and dQ must launch as often as the
   blocks and steps need (remat's recompute included).  One inner step's
   gradients through the kernels against the plain path's, leaf by
   leaf, 4 blocks deep, in f32 and bf16.

7. The continuous-batching engine at full width: ``dipaco-150m`` (bf16,
   ``attn_impl="pallas"``, 4 paths of 8 slots over a 512-token ring)
   serves a Poisson trace of 64 requests (200 a second, prompts of 32,
   64 or 128 tokens, 32 new, 30% interactive and 70% preemptible) routed
   by a prompt hash, in realtime with the eager tick and with the dense
   tick replayed from a CUDA graph, then both again on a simulated clock
   (10 ms a tick: the same admissions in both), whose greedy tokens must
   be equal and which must preempt and exert backpressure, then in
   realtime routed by a discriminative router re-routing every 8 tokens.
   Every request must finish and every slot come back; flash-decode must
   launch once a block for each decode the host dispatched, flash
   attention once a block for each feature call, and torch.profiler must
   see 12 flash-decode kernels in each replay of the graph.  Prints per
   run tok/s, p50/p99 latency and TTFT, ticks, the median tick (the
   ``serve.tick`` spans), the device busy share and peak memory, beside
   the card.  Then ``mamba2-1.3b`` (4 of 48 blocks, f32, 2 paths of 4
   slots, 16 requests): the stacked tick's tokens must equal the looped
   tick's.

8. The §3 training service at full width, on phase 4's ``dipaco-150m``
   (bf16, ``attn_impl="pallas"``), sharded documents and base weights,
   cut to their first 2 of 12 blocks (every row moves a whole tree, and
   at 12 blocks the phase writes about 110 GB, more than the 45 GiB of
   writes a machine takes a run), a 2x2 DiPaCo with batch 8 a worker
   and tau 4, its ``CheckpointDB`` under ``tempfile.mkdtemp()`` (the
   run's own temporary directory), removed at the end; it fails if its
   rows pass 40 GB.  ``make_trainer(backend="barrier")`` on 4 pool
   threads for 2 phases against ``backend="vector"`` from the same
   weights (per-phase losses and every path's parameters, leaf by leaf,
   within the stated bf16 tolerance; phase seconds, row-write seconds and
   the DB's bytes printed), and two barrier runs with a planted fault
   (worker 0's weight halved; worker 0's delta lost) whose first phase
   must break that tolerance; ``backend="service"`` with a staleness
   window of 1, 4 fragments, the int8 wire and preemptions (p 0.2) on 4
   threads for 3 phases, its outer step without momentum (at tau 4 the
   default 0.9 overshoots by the third phase, more so with stale deltas;
   the probe below shows it) (every path at phase 3, finite losses
   falling phase after phase, at least one preemption, no handler error,
   ``comm_stats()``: wire bytes against fp32; the third phase under
   torch.profiler for the device busy share); and kill and resume on one
   thread at lag 0: 3 phases uninterrupted, and the DB as it stood after
   phase 2 (hard-linked, so its rows are written once) taken up by
   ``resume`` for 1 more phase, whose path parameters and per-phase
   losses must be equal bit for bit.  The attention kernels' launch
   counts must match the workers' steps.

9. The deployment plane (``repro_torch.deploy``), the engines' hot swap
   and the serving fleet, under one ``tempfile.mkdtemp()`` removed at
   the end.  (a) ``dipaco-150m`` at full width (bf16, ``attn_impl=
   "pallas"``, a 2x2 partition, 4 paths): a ``DeploymentRegistry``
   whose v1 is the base; ``ShardedOuterExecutors`` apply one outer phase
   of small random deltas, and ``Publisher.publish_cycle`` with a
   ``CanaryGate`` scores it on the card and promotes v2 while a request
   is in flight on the continuous engine, whose dense tick was captured
   in a CUDA graph at v1.  The drain swap: the 4 requests admitted after
   it (one an island, decoded through graph replays) must equal a fresh
   eager engine's on v2 and differ from v1's; a second candidate of
   planted noise rows must be rejected and quarantined; a rollback to v1
   installed live must flag the requests in flight, leave the engine's
   weights bit-equal to ``materialize(v1)`` and give the v1 run's tokens
   again; the one-shot engine follows one promote.  torch.profiler must
   see 12 flash-decode kernels in each replay after the swaps; flash
   attention launches once a block for each canary forward, flash decode
   once a block for each decode the host dispatched.  (b) phase 8's cut
   (2 of 12 blocks): one barrier phase on one pool thread, on a thread
   of its own, while the engine serves a stream of requests; the
   publisher's background thread promotes the outer update within one
   canary cycle, the engine swaps to it, and every kernel launches as
   the steps, canary forwards and decodes need.  (c) ``ServingFleet(
   size=2, backend="process")`` on (a)'s registry: two spawned engine
   processes on the card whose tokens must equal the in-process fleet's
   on 8 requests half a second apart, and one promote must move both
   (``wait_version``).  Prints the install seconds and the ticks around
   each swap, the canary and publish-to-servable seconds, the bytes
   written and the phase's seconds; fails above 8 GB written, or above
   44 GB with phase 8's rows.

10. The ``"mesh"`` backend (``make_trainer(backend="mesh")``,
   ``repro_torch.launch.{mesh,steps,train}``) on phase 4's
   ``dipaco-150m`` shards and base weights at full width (bf16,
   ``attn_impl="pallas"``): a 2x2 DiPaCo, 4 workers of batch 8, tau 4,
   K = 2 fragments, the int8 wire.  (a) A world of one NCCL rank, all 12
   blocks, 2 phases: the worker params, the f32 global copies, the AdamW
   moments, the fragment states and the residuals must equal the
   single-process oracle's (``core.diloco.segmented_streaming_phase``
   driven by the same segment function from the same weights) bit for
   bit; each phase's mean loss finite and falling; the LSE forward,
   dK/dV and dQ launched as the blocks, workers and steps need (remat's
   recompute included).  Prints the phase seconds, peak memory,
   ``comm_stats``, the int8 wire against fp32 and the bytes gathered, and
   from a profiled third phase the gathers' device time and how much of
   it overlapped the compute stream.  (b) Two spawned gloo ranks sharing
   the card (NCCL refuses two ranks on one device), 2 workers each, with
   a process-group timeout and a join deadline: every path's parameters,
   the losses and the comm accounting after 2 phases equal (a)'s bit for
   bit.  (c) Kill and resume at phase 8's cut (2 of 12 blocks): 1 phase
   with its phase-state file, the trainer dropped, ``resume``, 1 more
   phase, against 2 uninterrupted phases bit for bit; the files (about
   4.3 GB each) go to ``/dev/shm``, not the disk, fail above 10 GB, and
   are removed.

11. The other families at full width, in bf16 with ``attn_impl=
   "pallas"``, each family's weights freed before the next's are drawn;
   nothing written to the disk.  ``dipaco-dense-1b`` (24 blocks, 1
   path), ``qwen3-8b`` (18 of 36, 2 paths), ``pixtral-12b`` (20 of 40,
   1 path, text through the engine), ``moonshot-v1-16b-a3b`` (24 of its
   48 blocks of 64 experts top-6 plus 2 shared, 1 path of about 27 GiB)
   and ``jamba-v0.1-52b``
   (8 of its 32 blocks: one period of its pattern, 2 paths) serve phase
   3's traffic through the one-shot engine (the plain pass, then a
   profiled generate of 16-token prompts), every kernel launching as its
   blocks and steps need; prefill + 16 decodes through
   the kernels against the plain path in bf16 at the served depth and in
   f32 at 4 blocks (jamba at 8).  pixtral's patch stub: 2 requests of
   1024 patch positions and 64 text tokens through ``api.prefill`` and
   16 ``serve_step``s, kernels against plain.  ``whisper-base`` through
   ``models.api``: 8 requests of 1500 frames, a 16-token prompt
   replayed, 16 new tokens, with the cross K/V and without (the logits
   must agree), then kernels against plain (6 + 6 and 4 + 4 blocks).
   ``dipaco-dense-1b`` trained at 24 blocks through ``make_trainer(
   backend="vector")`` at levels (1,) (one worker, batch 8, phase 4's
   2048 documents as one shard, 2 phases of tau 4, remat): the loss
   must fall and the LSE forward, dK/dV and dQ launch exactly as the
   steps need.  One inner step's gradients, kernels against plain, for
   qwen3-8b, pixtral-12b (with 256 patch positions), moonshot and
   whisper-base (4 + 4) at 4 blocks in f32 and bf16, and jamba at 8 in
   bf16.  Phase 2 checks and times the kernels at these families'
   shapes beforehand: the expert GEMM and its dX / dW at moonshot's and
   jamba's capacities, flash decode at B8 H32 KH8 D128, the LSE forward
   and its backward at B8 S1024 H16 D128.  Then ``gemma-2b`` (all 18
   blocks, 2 paths; D 256, 8 query heads over 1 KV head),
   ``nemotron-4-340b`` (4 of its 96 blocks, 1 path of about 46.5 GB; D
   192, 96 heads over 8) and ``qwen3-moe-235b-a22b`` (8 of its 94
   blocks of 128 experts top-8, 1 path of about 42.3 GB; 64 heads over
   4) serve the same traffic, with prefill + decode against plain in
   bf16 at the served depth and in f32 at 4, 1 and 2 blocks.
   ``gemma-2b`` is trained at all 18 blocks and full width by
   ``train_family`` (levels (1,), batch 4: at batch 8 its step runs out
   of the card's memory; 2 phases of 2 inner steps, remat): the loss
   must fall and the LSE forward, dK/dV and dQ launch
   exactly as its blocks and steps need.  One inner step's gradients,
   kernels against plain, for gemma-2b at 4 blocks in f32 and bf16,
   nemotron-4-340b at 1 block in bf16 and qwen3-moe-235b-a22b at 2
   blocks in bf16 and 1 in f32.  nemotron and qwen3-moe are not trained
   through ``make_trainer``: the vector trainer's f32 state (a global
   copy, two AdamW moments and the outer momentum, 16 bytes a parameter)
   of nemotron's tables alone is 151 GB, and one qwen3-moe block with
   its tables (3.74 G parameters) needs about 75 GB with its bf16
   weights and gradients, before any activation.  Phase 2 checks and times their shapes too: flash decode at
   their query groups over phase 3's cache at the batch each path sees
   (B8, and gemma's 3 and 5) and over 2048 slots, the forward at their
   routing calls and at B2 S2048, the LSE forward, dK/dV and dQ where
   phase 11 runs them (B8 S1024 H8 KH1 D256, B2 S1024 H96 KH8 D192, B2
   S1024 H64 KH4 D128) and at ragged, windowed edges of D 192 and 256,
   and the expert GEMM at E128 d4096 f1536.

12. Algorithm 1 and the paper's variants at full width (``dipaco-150m``,
   bf16, remat, ``attn_impl="pallas"``), through the port's examples.
   (a) ``repro_torch.examples.train_dipaco.run`` at ``--preset paper``:
   2048 documents of 256 tokens, k-means into a 2x2 DiPaCo, batch 8, 4
   phases of tau 4, early stopping, a worker-stacked dump each phase
   under ``/dev/shm`` (removed; fails above 10 GB), and the
   discriminative re-shard after the second phase.  Every shard after
   it must be non-empty; ``score_documents`` at the re-shard must agree
   with the plain attention's within phase 2's bf16 bar a scored token
   (an argmax may differ only where the top two are closer); the phases'
   mean loss must fall from the first to the second, and the held-out
   loss on the new shards from the third to the fourth;
   ``path_params(p, best=True)`` must equal, bit for bit, its worker's
   parameters after its best phase, and the last dump, read back, the
   workers' parameters; the LSE forward, dK/dV, dQ, flash attention and
   ``router_assign`` must launch exactly as the run needs; the best
   paths are evaluated re-routed once a sequence, every 16 and every 8
   tokens by the re-shard's router.  (b) From (a)'s documents and base
   weights, 2 phases of tau 4 each, one trainer at a time: DiLoCo on 4
   uniform shards, flat MoE on (a)'s k-means shards, a path-specific
   second level, the synchronous trainer of §4.5, a 2x2 on product
   k-means shards (``router_assign`` at D 448 and K 2) and flat MoE on
   top-2 overlapping shards.  Each loss must fall, the attention kernels
   launch as the steps need, and workers that share a module hold it
   bit for bit after every outer step (the sync trainer: their mixed
   gradients at every step); phase seconds, peak memory and routed PPL
   beside (a)'s are printed.  (c) ``quickstart``, ``serve_paths``,
   ``train_and_serve`` (its registry under ``/dev/shm``) and
   ``multiarch_smoke`` over all twelve configs at their scripts' sizes:
   each must end, the two that serve must launch flash decode,
   ``train_and_serve`` must swap and roll back, and every
   architecture's loss must fall.

``python3 chip_smoke.py --service-probe`` runs phase 4's pipeline and a
probe of the stale service's loss (the vector trainer and the service
on one thread at lag 0, at lag 1 and at lag 1 without outer momentum,
at 12 blocks and at 2; at 2 also phase 8's service run twice at the
default outer momentum), then
phase 8, then phase 8's barrier and planted faults at 12 blocks.  At
12 blocks a service run writes up to about 40 GB of rows under
``TMPDIR``: give it a ``TMPDIR`` in memory (``/dev/shm``) that holds
them.  ``python3 chip_smoke.py --deploy`` runs phase 4's pipeline and
then phase 9 alone, ``python3 chip_smoke.py --mesh`` phase 4's pipeline
and then phase 10 alone, ``python3 chip_smoke.py --families`` phase 2
and then phase 11 alone, ``python3 chip_smoke.py --examples`` phase 12
alone after the build.

It prints one ``{"kernels": [...]}`` line before the card's line, with
the backward kernels' rows too, and the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import bisect
import dataclasses
import datetime
import functools
import gc
import json
import multiprocessing as mp
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import make_trainer  # noqa: E402
from repro_torch.configs import ALL_CONFIGS, get_config  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.diloco import (fragment_state_init,  # noqa: E402
                                     segmented_streaming_phase)
from repro_torch.core.fragments import FragmentSpec, segment_bounds  # noqa: E402
from repro_torch.core.module_store import ModuleStore  # noqa: E402
from repro_torch.core.routing import (DiscriminativeRouter,  # noqa: E402
                                      KMeansRouter, evaluate_rerouted,
                                      kmeans_assign, kmeans_fit,
                                      prefix_features, product_kmeans_assign,
                                      product_kmeans_fit, score_documents,
                                      topn_assign)
from repro_torch.data import SyntheticCorpus, shard_documents  # noqa: E402
from repro_torch.deploy import (CanaryGate, DeploymentRegistry,  # noqa: E402
                                Publisher)
from repro_torch.infra import ShardedOuterExecutors, ckpt_db  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention import flash_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    attention_delta, dkv_launches, flash_attention_dkv, flash_attention_dq,
    flash_attention_lse)
from repro_torch.core.dipaco import (SyncDiPaCoTrainer,  # noqa: E402
                                     diloco_config, flat_moe_config,
                                     mean_nll, stack_tree)
from repro_torch.data.loader import phase_batches  # noqa: E402
from repro_torch.examples import (multiarch_smoke, quickstart,  # noqa: E402
                                  serve_paths, train_and_serve, train_dipaco)
from repro_torch.kernels.moe_gmm import (expert_gemm, expert_gemm_dw,  # noqa: E402
                                         expert_gemm_dx)
from repro_torch.kernels.router_assign import router_assign  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd  # noqa: E402
from repro_torch.launch import dryrun, flopmodel, specs  # noqa: E402
from repro_torch.launch import steps as launch_steps  # noqa: E402
from repro_torch.launch.steps import (make_segment_scan_fn,  # noqa: E402
                                      row, value_and_grad)
from repro_torch.models import api, encdec, moe_layer  # noqa: E402
from repro_torch.models.config import (INPUT_SHAPES,  # noqa: E402
                                       DiPaCoConfig, InputShape)
from repro_torch.models.layers import torch_dtype  # noqa: E402
from repro_torch.models.params import (LAYERS, param_axes,  # noqa: E402
                                       tree_leaves)
from repro_torch.optim import adamw_init, adamw_update_  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402
from repro_torch.obs import Telemetry, read_trace  # noqa: E402
from repro_torch.serving import (PRIO_HIGH, PRIO_PREEMPTIBLE,  # noqa: E402
                                 ContinuousBatchingEngine, EngineOptions,
                                 PathServingEngine, Request, ServingFleet,
                                 poisson_trace, prefix_hash_router)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# the rate for each input type (bf16 and TF32 on the tensor cores, f32
# outside them), from their one home in the dry-run's roofline
from repro_torch.launch.comm_analysis import (HBM_BYTES_PER_S,  # noqa: E402
                                              PEAK_FLOPS_BF16,
                                              PEAK_OPS_PER_S)
# kernel vs plain version on the same inputs: both accumulate in f32, so
# f32 differs only by summation order; a bf16 output may differ by one
# bf16 rounding of values below 4 (2^-7 at most).  The SSD's f32 check is
# relative to its largest output: its segment-difference form
# exp(cum_l - cum_s) loses about |cum| 2^-24 in each exponent on either
# side, and |cum| grows to a few hundred over a 256-token chunk
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# gradients, relative to the largest of each output: f32 differs by
# summation order only, bf16 by one bf16 rounding of each output
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PROMPT_LEN, MAX_NEW, NUM_PATHS, REQUESTS, REROUTE_EVERY = 64, 16, 4, 8, 4
CACHE_LEN = PROMPT_LEN + MAX_NEW
# prompt tokens in the profiled generate of the SSM and MoE families (the
# processing of a 48-block model's profile grows with its ~1,400
# operations a step); dipaco-150m keeps its 64
PROFILE_PROMPT = 16
# the training phase: documents, their length, K = paths = workers, the
# batch per worker, inner steps per phase, phases, Lloyd iterations
DOCS, DOC_LEN, TRAIN_PATHS, TRAIN_BATCH, TAU, PHASES, KMEANS_ITERS = \
    2048, 1024, 4, 8, 4, 2, 25
# frequent-token routing in phase 4: re-route the validation documents
# every 64 tokens
REROUTE_TRAIN = 64
# one inner step's gradients through the kernels vs the plain attention,
# ||a - b|| / ||b|| per leaf after 12 blocks: f32 differs by summation
# order; bf16 by the rounding of every activation on both paths
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# the SSM and token-MoE families served at full width: (name, paths,
# blocks served, {dtype: max |dlogit| tolerance of prefill + decode},
# that check's prompt tokens and batch, and the blocks of its f32 run, or
# None for the blocks served).  Both are cut to half their depth (24 of
# mamba2-1.3b's 48, 12 of qwen2-moe-a2.7b's 24), so that the default run
# ends within 1000 s on a slow host (PERF.md section 4).  f32: summation
# order only: the GEMM's d sums (1e-3, as dipaco-150m's check), and the
# SSD's segment differences, about 3e-5 of each block's scan output (see
# TOL) carried through up to 48 blocks onto logits of a few units
# (1e-2).  bf16: one rounding of each kernel output, carried through up
# to 48 blocks of mamba2-1.3b or 24 of qwen2-moe-a2.7b (1.0, as against
# logits of about 4 to 5).  The MoE check is teacher-forced
# (ForcedExperts): a near-tie among 60 router probabilities would flip a
# token's top-4 set between the runs and, through it, every later block
# and position.  mamba2-1.3b prefills 2 prompts of 2048 tokens (8
# chunks); qwen2-moe-a2.7b 8 of 48, its f32 weights cut to 8 blocks (56
# GB at 24), widths unchanged.
FAMILIES = (
    ("mamba2-1.3b", 4, 24, {"float32": 1e-2, "bfloat16": 1.0}, 2048, 2,
     None),
    ("qwen2-moe-a2.7b", 2, 12, {"float32": 1e-3, "bfloat16": 1.0},
     PROMPT_LEN - MAX_NEW, REQUESTS, 8),
)


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn) -> float:
    """The call replayed from a CUDA graph: the device's time without the
    host's launch cost (captured on a side stream after one warm-up
    call there)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# the mangled names of the bf16 backward kernels at head_dim 192 and 256
WIDE_BWD = re.compile(r"(dkv|dq)_wgmmaILi(192|256)E")


def tensor_core_sass() -> None:
    """The bf16 paths of the attention kernels, expert_gemm and the SSD
    scan (its three passes, and the backward's chunk states), and both
    paths of router_assign, run on wgmma fed by TMA: their machine code
    must hold both instructions (HGMMA, UTMALDG).  flash_decode stages
    K and V by TMA (UTMALDG) or bulk copies (UBLKCP)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    need = {name: (("HGMMA",), ("UTMALDG",)) for name in (
        "moe_gmm", "flash_attention", "flash_attention_bwd", "router_assign",
        "ssd_scan", "ssd_scan_bwd")}
    need["decode_attention"] = (("UTMALDG", "UBLKCP"),)
    for name, groups in need.items():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build.lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        found = {op: sass.count(op) for group in groups for op in group}
        print(f"[sass {name}] {found}")
        assert all(any(found[op] for op in group) for group in groups), \
            (name, found)


def decode_smem() -> None:
    """flash decode's dynamic shared memory a block, for every head dim,
    cache dtype and head-group size: each must fit the 227 KB (232,448
    bytes) a block of the H100 may take."""
    sizes = {f"D{d} {str(t)[6:]} G{g}": decode_attention.smem_bytes(d, t, g)
             for d in decode_attention.HEAD_DIMS
             for t in (torch.float32, torch.bfloat16, torch.int8)
             for g in range(1, decode_attention.MAX_GROUP + 1)}
    print(f"[smem decode_attention] {sizes}")
    assert max(sizes.values()) <= 232448, sizes


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def attention_pairs(s: int, causal: bool, window) -> int:
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return int(mask.sum())


def check_flash_attention(gen) -> dict:
    # (B, S, H, KH, D, window): the routing features' shape in
    # dipaco-150m and in qwen2-moe-a2.7b, a long sequence, a ragged S with
    # a window under GQA, and the other head dims; then the edges of the
    # bf16 tensor-core tiling: S 1, S 65 (a second tile of one key), D 32
    # (64-byte swizzle) and D 128 (two column boxes) under windows and GQA
    cases = [(8, 32, 16, 16, 64, None), (8, 32, 16, 16, 128, None),
             (2, 2048, 16, 16, 64, None),
             (2, 1000, 16, 4, 64, 256), (1, 333, 8, 8, 128, None),
             (2, 77, 4, 2, 32, 16), (2, 1, 4, 2, 64, None),
             (2, 65, 4, 2, 64, None), (1, 65, 8, 2, 32, 16),
             (2, 333, 8, 2, 128, 100)]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, kh, d, w in cases:
            q = randn(gen, b, s, h, d, dtype=dtype)
            k = randn(gen, b, s, kh, d, dtype=dtype)
            v = randn(gen, b, s, kh, d, dtype=dtype)
            out = flash_attention(q, k, v, causal=True, window=w)
            torch.cuda.synchronize()
            plain = ref.flash_attention_ref(q, k, v, causal=True, window=w)
            err = (out.float() - plain.float()).abs().max().item()
            row = {"shape": [b, s, h, kh, d], "window": w,
                   "dtype": str(dtype), "max_abs_err": err,
                   "tol": TOL[dtype]}
            rows.append(row)
            print(f"[flash_attention] {row}")
            assert err <= TOL[dtype], row
    # timings in bf16 at the serving path's shape (routing features) and
    # at a long sequence, where device work outweighs the launch
    main = fa_timings(gen, 8, 32, 16, 64)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": None, **main,
        "library_call": "F.scaled_dot_product_attention(is_causal=True)",
        "long": fa_timings(gen, 2, 2048, 16, 64), "cases": rows}


def fa_timings(gen, b, s, h, d, kh=None) -> dict:
    """bf16, causal: eager and from a CUDA graph, beside SDPA (with
    ``enable_gqa`` where there are fewer KV heads than query heads)."""
    dtype = torch.bfloat16
    kh = kh or h
    q = randn(gen, b, s, h, d, dtype=dtype)
    k, v = (randn(gen, b, s, kh, d, dtype=dtype) for _ in range(2))
    err = (flash_attention(q, k, v).float()
           - ref.flash_attention_ref(q, k, v).float()).abs().max().item()
    assert err <= TOL[dtype], (b, s, h, kh, d, err)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = {"enable_gqa": True} if kh != h else {}
    bound_ms, bound_by = bound(nbytes(q, k, v, q),
                               4 * d * h * b * attention_pairs(s, True, None),
                               dtype)
    return {
        "shape": [b, s, h, kh, d], "dtype": "bf16",
        "max_abs_err": err, "max_err": err,
        "ms": time_ms(lambda: flash_attention(q, k, v)),
        "graph_ms": graph_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa))}


def quantize(x):
    scale = torch.clamp_min(x.float().abs().amax(-1) / 127.0, 1e-8)
    qx = torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127)
    return qx.to(torch.int8), scale


def decode_work(ci, T, kh, d, window, h, elem) -> tuple:
    """(bytes, ops) that one decode call needs: the valid slots of K and
    V (and their scales when elem == 1), q and the output."""
    pos = ref.ring_positions(ci, T)
    valid = (pos >= 0) & (pos <= ci.long()[:, None])
    if window is not None:
        valid &= pos > ci.long()[:, None] - window
    n_valid = int(valid.sum())
    b = ci.shape[0]
    kv = 2 * n_valid * kh * (d * elem + (4 if elem == 1 else 0))
    return kv + 2 * b * h * d * 2 + 4 * b, 4.0 * d * h * n_valid


def check_flash_decode(gen) -> dict:
    # (B, H, KH, D, T, window, cache_index): the path's cache at its last
    # step and mid-prompt, in dipaco-150m (D 64) and qwen2-moe-a2.7b (D
    # 128), a large batch over a long cache with ring wrap, GQA with a
    # window over a wrapped ring, and the other head dims
    rng = np.random.default_rng(0)
    cases = [(8, 16, 16, d, CACHE_LEN, None, ci) for d in (64, 128)
             for ci in ([CACHE_LEN - 1] * 8, list(range(0, 80, 10)))]
    cases += [(64, 16, 16, 64, 2048, None,
               rng.integers(0, 3 * 2048, 64).tolist()),
              (8, 16, 4, 64, 512, 128, rng.integers(0, 2000, 8).tolist()),
              (3, 8, 1, 128, 100, None, [0, 99, 250]),
              (2, 4, 2, 32, 40, 12, [7, 90]),
              # one (b, kh) row over a long cache: several splits meet at
              # the arrival counter (MHA; GQA, window, wrapped; MQA)
              (1, 16, 16, 64, 2048, None, [2047]),
              (1, 16, 2, 128, 2048, 700, [3000]),
              (1, 4, 1, 32, 2048, None, [5000]),
              # phase 7's stacked tick: 4 paths x 8 slots over a 512-token
              # ring at the positions of its prompts and new tokens, and
              # free slots parked at position 0
              (CB_PATHS * CB_SLOTS, 16, 16, 64, CB_CACHE, None,
               [0 if i % 4 == 0 else int(c) for i, c in enumerate(
                   rng.integers(32, 160, CB_PATHS * CB_SLOTS))])]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for int8 in (False, True):
            for b, h, kh, d, T, w, ci in cases:
                q = randn(gen, b, h, d, dtype=dtype)
                kc = randn(gen, b, T, kh, d, dtype=dtype)
                vc = randn(gen, b, T, kh, d, dtype=dtype)
                cit = torch.tensor(ci, dtype=torch.int32, device="cuda")
                ks = vs = None
                if int8:
                    (kc, ks), (vc, vs) = quantize(kc), quantize(vc)
                out = flash_decode(q, kc, vc, cit, window=w, k_scale=ks,
                                   v_scale=vs)
                torch.cuda.synchronize()
                plain = ref.flash_decode_ref(q, kc, vc, cit, window=w,
                                             k_scale=ks, v_scale=vs)
                err = (out.float() - plain.float()).abs().max().item()
                row = {"shape": [b, h, kh, d, T], "window": w,
                       "dtype": str(dtype), "int8": int8,
                       "max_abs_err": err, "tol": TOL[dtype]}
                rows.append(row)
                print(f"[flash_decode] {row}")
                assert err <= TOL[dtype], row
    # timings in bf16 at the serving path's shape (all 8 requests, last
    # step), at a large batch over a long, wrapped ring, and at phase 7's
    # stacked tick (4 paths x 8 slots over a 512-token ring, positions of
    # prompts of 32-128 tokens with up to 32 new)
    main = fd_timings(gen, 8, 16, 64, CACHE_LEN, [CACHE_LEN - 1] * 8)
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:103",
        "launches": None, **main,
        "library_call": "F.scaled_dot_product_attention(attn_mask=ring mask)",
        "long": fd_timings(gen, 64, 16, 64, 2048,
                           rng.integers(0, 3 * 2048, 64).tolist()),
        "tick": fd_timings(gen, CB_PATHS * CB_SLOTS, 16, 64, CB_CACHE,
                           rng.integers(32, 160, CB_PATHS * CB_SLOTS)
                           .tolist()),
        "cases": rows}


def fd_timings(gen, b, h, d, T, ci, kh=None) -> dict:
    """bf16: eager (the host's launch cost included) and replayed from a
    CUDA graph, beside masked SDPA (with ``enable_gqa`` where there are
    fewer KV heads than query heads) timed both ways."""
    dtype = torch.bfloat16
    kh = kh or h
    q = randn(gen, b, h, d, dtype=dtype)
    kc, vc = (randn(gen, b, T, kh, d, dtype=dtype) for _ in range(2))
    cit = torch.tensor(ci, dtype=torch.int32, device="cuda")
    err = (flash_decode(q, kc, vc, cit).float()
           - ref.flash_decode_ref(q, kc, vc, cit).float()).abs().max().item()
    assert err <= TOL[dtype], (b, h, kh, d, T, err)
    n_bytes, n_ops = decode_work(cit, T, kh, d, None, h, kc.element_size())
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
    pos = ref.ring_positions(cit, T)
    mask = ((pos >= 0) & (pos <= cit.long()[:, None]))[:, None, None, :]
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    gqa = {"enable_gqa": True} if kh != h else {}

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              **gqa)

    out = {
        "shape": [b, h, kh, d, T], "dtype": "bf16",
        "max_abs_err": err, "max_err": err,
        "ms": time_ms(lambda: flash_decode(q, kc, vc, cit)),
        "graph_ms": graph_ms(lambda: flash_decode(q, kc, vc, cit)),
        "plain_ms": time_ms(lambda: ref.flash_decode_ref(q, kc, vc, cit)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(sdpa), "library_graph_ms": graph_ms(sdpa)}
    out["bound_share_graph"] = bound_ms / out["graph_ms"]
    return out


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def training_attention(q, k, v, do, causal, window) -> tuple:
    """The three training kernels on one input, and their plain versions:
    -> (kernel outputs, plain outputs), each (o, lse, dq, dk, dv)."""
    o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    po, plse = ref.fwd_with_lse_ref(q, k, v, causal=causal, window=window)
    # the backward kernels take the plain forward's o and lse, so each
    # kernel is held against its own plain version on the same inputs
    delta = attention_delta(do, po)
    dk, dv = flash_attention_dkv(q, k, v, do, plse, delta, causal=causal,
                                 window=window)
    dq = flash_attention_dq(q, k, v, do, plse, delta, causal=causal,
                            window=window)
    torch.cuda.synchronize()
    pdq, pdk, pdv = ref.flash_attention_bwd_ref(q, k, v, po, plse, do,
                                                causal=causal, window=window)
    return (o, lse, dq, dk, dv), (po, plse, pdq, pdk, pdv)


def held_to_plain(got, plain, row: dict, dtype, s: int) -> dict:
    """The training kernels' outputs (``training_attention``) against
    their plain versions: o within TOL, the LSE within 1e-4, dQ, dK and dV
    within GRAD_TOL of the largest of each.  Fills ``row`` with the
    errors and the bars, prints it, and fails if one is over its bar."""
    errs = {n: rel_err(a, p) for n, a, p in
            zip(("o", "lse", "dq", "dk", "dv"), got, plain)}
    errs["o"] = (got[0].float() - plain[0].float()).abs().max().item()
    errs["lse"] = (got[1] - plain[1]).abs().max().item()
    row.update({"dtype": str(dtype), "o_max_abs_err": errs["o"],
                "lse_max_abs_err": errs["lse"],
                "grad_rel_err": {n: errs[n] for n in ("dq", "dk", "dv")},
                "tol": {"o": TOL[dtype], "lse": 1e-4,
                        "grad_rel": GRAD_TOL[dtype]}})
    rel = ("dq", "dk", "dv")
    if s == 1:
        # one key: P is 1 and dP equals delta, so dS, dq and dk are
        # zero but for rounding: held to TOL in absolute terms
        rel = ("dv",)
        row["zero_grad_max_abs"] = {
            n: got[i].float().abs().max().item()
            for n, i in (("dq", 2), ("dk", 3))}
    print(f"[train_attention] {row}")
    assert errs["o"] <= TOL[dtype] and errs["lse"] <= 1e-4, row
    assert all(errs[n] <= GRAD_TOL[dtype] for n in rel), row
    assert all(e <= TOL[dtype] for e in
               row.get("zero_grad_max_abs", {}).values()), row
    return row


def check_training_case(gen, b, s, h, kh, d, causal, w, dtype) -> dict:
    q, do = (randn(gen, b, s, h, d, dtype=dtype) for _ in range(2))
    k, v = (randn(gen, b, s, kh, d, dtype=dtype) for _ in range(2))
    got, plain = training_attention(q, k, v, do, causal, w)
    return held_to_plain(got, plain, {"shape": [b, s, h, kh, d],
                                      "causal": causal, "window": w},
                         dtype, s)


def check_training_attention(gen) -> list:
    # (B, S, H, KH, D, causal, window): the five backward cases of
    # tests/test_kernels.py (ragged S = 80, a non-causal GQA window), the
    # other head dims, the training shape, and three edges of the bf16
    # tensor-core tiling (S 65 at D 128 under a window, and at D 32 with
    # GQA, not causal; S 1)
    cases = [(2, 128, 4, 2, 32, True, None), (2, 96, 2, 1, 64, True, 24),
             (2, 64, 4, 4, 32, False, None), (2, 80, 2, 2, 32, True, None),
             (2, 64, 4, 2, 32, False, 16), (2, 200, 4, 4, 128, True, None),
             (1, 333, 8, 2, 64, True, 100), (8, 1024, 16, 16, 64, True, None),
             (2, 65, 4, 2, 128, True, 7), (2, 65, 8, 2, 32, False, None),
             (2, 1, 4, 2, 64, True, None)]
    return [check_training_case(gen, *case, dtype)
            for dtype in (torch.bfloat16, torch.float32) for case in cases]


def backward_is_deterministic(q, k, v, do, lse, delta) -> dict:
    """Two launches of each backward kernel on the same inputs give the
    same bits: every block owns its output rows (no atomics)."""
    first = (*flash_attention_dkv(q, k, v, do, lse, delta),
             flash_attention_dq(q, k, v, do, lse, delta))
    second = (*flash_attention_dkv(q, k, v, do, lse, delta),
              flash_attention_dq(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    same = {n: bool(torch.equal(a, b)) for n, a, b in
            zip(("dk", "dv", "dq"), first, second)}
    print(f"[train_attention] bit-identical relaunch: {same}")
    assert all(same.values()), same
    return same


def training_attention_timings(gen, b, s, h, d, kh=None) -> list:
    """bf16 at the training shape: each kernel, its plain version, its
    bound, and SDPA as the yardstick (``enable_gqa`` where there are
    fewer KV heads than query heads): its forward for the LSE forward,
    its backward alone (``autograd.grad`` of a kept forward) for dK/dV
    and dQ, which it computes together.  The backward is also printed
    as forward+backward minus forward, a reading that spreads more
    between calls.  The timed inputs' outputs are held to their plain
    versions as ``check_training_attention``'s cases are, and both
    backward kernels relaunched for identical bits."""
    dtype = torch.bfloat16
    kh = kh or h
    q, do = (randn(gen, b, s, h, d, dtype=dtype) for _ in range(2))
    k, v = (randn(gen, b, s, kh, d, dtype=dtype) for _ in range(2))
    got, plain = training_attention(q, k, v, do, True, None)
    held = held_to_plain(got, plain, {"shape": [b, s, h, kh, d],
                                      "causal": True, "window": None},
                         dtype, s)
    o, lse = plain[0], plain[1]
    delta = attention_delta(do, o)
    pairs = attention_pairs(s, True, None)
    work = {   # (bytes read and written once, operations)
        "lse": (nbytes(q, k, v, o, lse), 4 * d * h * b * pairs),
        "dkv": (nbytes(q, k, v, do, lse, delta, k, v), 8 * d * h * b * pairs),
        "dq": (nbytes(q, k, v, do, lse, delta, q), 6 * d * h * b * pairs)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    gqa = {"enable_gqa": True} if kh != h else {}

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              **gqa)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    kept = sdpa_fwd()

    def sdpa_bwd():
        torch.autograd.grad(kept, (qt, kt, vt), dot, retain_graph=True)

    fwd_ms = time_ms(sdpa_fwd)
    bwd_ms = time_ms(sdpa_bwd)
    bwd_diff_ms = time_ms(sdpa_fwd_bwd) - fwd_ms
    print(f"[train_attention] SDPA backward {bwd_ms:.4f} ms alone, "
          f"{bwd_diff_ms:.4f} ms as forward+backward minus forward")
    same = backward_is_deterministic(q, k, v, do, lse, delta)
    sdpa_call = ("F.scaled_dot_product_attention(is_causal=True, "
                 "enable_gqa=True)" if gqa else
                 "F.scaled_dot_product_attention(is_causal=True)")
    timed = {
        "lse": (lambda: flash_attention_lse(q, k, v),
                lambda: ref.fwd_with_lse_ref(q, k, v), fwd_ms,
                f"{sdpa_call}, forward"),
        "dkv": (lambda: flash_attention_dkv(q, k, v, do, lse, delta),
                lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do),
                bwd_ms, "SDPA backward alone (autograd.grad of a kept "
                "forward); it computes dQ, dK and dV together"),
        "dq": (lambda: flash_attention_dq(q, k, v, do, lse, delta),
               lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do),
               bwd_ms, "SDPA backward alone (autograd.grad of a kept "
               "forward); it computes dQ, dK and dV together")}
    meta = {"lse": ("flash_attention_lse", "flash_attention.cu",
                    "src/repro/kernels/flash_attention_bwd.py:116", (0, 1)),
            "dkv": ("flash_attention_dkv", "flash_attention_bwd.cu",
                    "src/repro/kernels/flash_attention_bwd.py:293", (3, 4)),
            "dq": ("flash_attention_dq", "flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention_bwd.py:331", (2,))}
    out = []
    for key, (kernel, plain_fn, lib_ms, lib_call) in timed.items():
        name, src, replaces, idx = meta[key]
        bound_ms, bound_by = bound(*work[key], dtype)
        err = max((got[i].float() - plain[i].float()).abs().max().item()
                  for i in idx)
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": None,
            "shape": [b, s, h, kh, d], "dtype": "bf16", "max_abs_err": err,
            "ms": time_ms(kernel, 20), "plain_ms": time_ms(plain_fn, 5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_call": lib_call,
            "check": held})
        if key != "lse":
            out[-1]["library_ms_fwd_bwd_minus_fwd"] = bwd_diff_ms
            out[-1]["bit_identical_relaunch"] = same
    return out


def assign_flips(z, c, a, pa, tol_rel: float = 1e-5) -> tuple:
    """Kernel vs plain argmin: a flip counts as wrong only where the two
    best distances are more than ``tol_rel`` of the distance scale
    apart.  -> (flips, wrong flips)."""
    from repro_torch.core.routing.kmeans import squared_distances
    full = squared_distances(z, c)
    top2 = torch.topk(-full, min(2, c.shape[0]), dim=-1).values
    gap = (top2[:, 0] - top2[:, -1]).abs()
    differ = a != pa
    wrong = differ & (gap > tol_rel * full.abs().max())
    return int(differ.sum()), int(wrong.sum())


# phase 12's assignments: product k-means' halves (its 2048 documents,
# half of d_model, 2 centroids a half) and the validation documents
# against the 4 centroids (256 of them)
ALG1_ASSIGN = ((2048, 448, 2), (256, 896, 4))


def check_router_assign(gen) -> dict:
    # (N, D, K): ragged N, the paper's table (one centroid tile of 256),
    # the training phase's features (2048 documents, d_model, K = 4),
    # phase 12's shapes (ALG1_ASSIGN), then the edges of the tensor-core
    # tiling: K 1, K 257 (two tiles of 192), D 36 (f32 on TMA, bf16 on the
    # CUDA cores), D 50 (the CUDA-core kernel in both types), N 131 K 33
    cases = [(513, 32, 8), (65536, 896, 256), (DOCS, 896, TRAIN_PATHS),
             (777, 896, 1), (1000, 128, 257), (333, 36, 24), (200, 50, 40),
             (131, 64, 33), *ALG1_ASSIGN]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for n, d, k in cases:
            z, c = randn(gen, n, d, dtype=dtype), randn(gen, k, d, dtype=dtype)
            a, d2 = router_assign(z, c)
            torch.cuda.synchronize()
            pa, pd2 = ref.router_assign_ref(z, c)
            flips, wrong = assign_flips(z, c, a, pa)
            err = (d2 - pd2).abs().max().item()
            scale = pd2.abs().max().item()
            row = {"shape": [n, d, k], "dtype": str(dtype), "flips": flips,
                   "wrong_flips": wrong, "mind2_max_abs_err": err,
                   "mind2_scale": scale, "tol_rel": 1e-5}
            rows.append(row)
            print(f"[router_assign] {row}")
            assert wrong == 0 and flips <= 1e-3 * n, row
            assert err <= 1e-5 * max(scale, 1.0), row
    main = ra_timings(gen, DOCS, 896, TRAIN_PATHS)
    return {"name": "router_assign", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/router_assign.cu",
            "replaces": "src/repro/kernels/router_assign.py:29",
            "launches": None, **main,
            "library_call": "torch.cdist + argmin",
            "long": ra_timings(gen, 65536, 896, 256),
            "product_kmeans": ra_timings(gen, *ALG1_ASSIGN[0]), "cases": rows}


def ra_timings(gen, n, d, k) -> dict:
    """f32, as k-means calls it.  The route's bound: three TF32 products
    on the tensor cores (``bound_ms``, what the kernel is judged by);
    beside it the f32 CUDA-core bound of the kernel it replaced."""
    z, c = randn(gen, n, d, dtype=torch.float32), \
        randn(gen, k, d, dtype=torch.float32)
    a, d2 = router_assign(z, c)
    pa, pd2 = ref.router_assign_ref(z, c)
    n_bytes = nbytes(z, c, a, d2)
    bound_ms, bound_by = bound(n_bytes, 3 * 2.0 * n * k * d, "tf32")
    cuda_cores_ms, cuda_cores_by = bound(n_bytes, 2.0 * n * k * d,
                                         torch.float32)
    return {"shape": [n, d, k], "dtype": "f32",
            "max_abs_err": (d2 - pd2).abs().max().item(),
            "ms": time_ms(lambda: router_assign(z, c)),
            "graph_ms": graph_ms(lambda: router_assign(z, c)),
            "plain_ms": time_ms(lambda: ref.router_assign_ref(z, c)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_f32_cuda_cores": cuda_cores_ms,
            "bound_by_f32_cuda_cores": cuda_cores_by,
            "library_ms": time_ms(lambda: torch.cdist(z, c).argmin(-1))}


def ssd_inputs(gen, b, s, h, p, g, n, dtype, pad=0):
    """x / 8, dt = softplus(z - 2) (f32), A = -(1..H) as the model's
    A_log gives it, and grouped B, C scaled so that C . B is about 1
    (outputs stay below 4, where one bf16 rounding is within TOL); with
    ``pad`` the last tokens are zero (dt = 0), as ``apply_mamba`` pads
    a ragged length to its chunk."""
    x = randn(gen, b, s, h, p, dtype=torch.float32).mul_(0.125).to(dtype)
    dt = F.softplus(randn(gen, b, s, h, dtype=torch.float32) - 2.0)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
    bm, cm = (randn(gen, b, s, g, n, dtype=torch.float32).mul_(n ** -0.25)
              .to(dtype) for _ in range(2))
    if pad:
        for t in (x, dt, bm, cm):
            t[:, s - pad:] = 0
    return x, dt, a, bm, cm


def ssd_work(x, dt, a, bm, cm, chunk) -> tuple:
    """(bytes, operations) of one scan: every input read once, y and the
    f32 final state written once; per chunk the causal half of C B^T once
    per group (L(L+1)/2 pairs, 2N each) and, per head, of the scores
    times x (2P each) and the chunk state and inter-chunk output (2LPN
    each)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    L, nc = chunk, s // chunk
    ops = b * nc * (g * L * (L + 1) * n + h * (L * (L + 1) * p
                                               + 4 * L * p * n))
    return nbytes(x, dt, a, bm, cm, x) + b * h * p * n * 4, float(ops)


def ssd_bwd_work(x, dt, a, bm, cm, chunk) -> tuple:
    """(bytes, operations) of one backward without a final-state gradient
    (as training calls it): x, dt, A, B, C, dy and the start states read
    once, dx, ddt, dA, dB, dC written once; per chunk C B^T once per group and, per head, dy xdt^T
    and the products into dC, dB, dxdt over the causal half, and the
    four state products (2LPN each)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    L, nc = chunk, s // chunk
    ops = b * nc * (g * L * (L + 1) * n + h * (L * (L + 1) * (p + 2 * n + p)
                                               + 8 * L * p * n))
    states = b * nc * h * p * n * 4
    return 2 * nbytes(x, dt, a, bm, cm) + nbytes(x) + states, float(ops)


# (B, S, H, P, G, N, chunk, padded tail): a full-width prefill (8 chunks),
# the routing prefix of the serving path (chunk = S = 32), phase 6's
# training shape (B4 S1024), a ragged length (1000 tokens padded to
# 1024), a 6-token prompt, phase 7's batch-1 prefills of 32 and 64
# tokens (one chunk each); then the edges of the
# bf16 tensor-core passes: G = H, chunk 32 / 64 / 100 / 256 (a chunk of 64
# + 36 tokens), each P and N
SSD_CASES = [(8, 2048, 64, 64, 1, 128, 256, 0), (8, 32, 64, 64, 1, 128, 32, 0),
             (4, 1024, 64, 64, 1, 128, 256, 0),
             (8, 1024, 64, 64, 1, 128, 256, 24), (8, 6, 64, 64, 1, 128, 6, 0),
             (1, 32, 64, 64, 1, 128, 32, 0), (1, 64, 64, 64, 1, 128, 64, 0),
             (2, 96, 4, 32, 4, 64, 32, 0), (2, 300, 8, 64, 8, 32, 100, 0),
             (1, 768, 16, 32, 1, 128, 256, 0), (2, 256, 16, 64, 2, 64, 64, 0),
             (3, 64, 4, 32, 2, 32, 64, 0)]


def check_ssd_scan(gen) -> dict:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, p, g, n, chunk, pad in SSD_CASES:
            x, dt, a, bm, cm = ssd_inputs(gen, b, s, h, p, g, n, dtype, pad)
            y, state, starts = ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                        states=True)
            torch.cuda.synchronize()
            py, pstate = ref.ssd_scan_ref(x, dt, a, bm, cm, chunk=chunk)
            err = (y.float() - py.float()).abs().max().item()
            serr = (state - pstate).abs().max().item()
            # the last chunk's start state: the final state of the others
            c = s // chunk - 1
            _, want = ref.ssd_scan_ref(*(t[:, :c * chunk] for t in (x, dt)),
                                       a, bm[:, :c * chunk],
                                       cm[:, :c * chunk], chunk=chunk) \
                if c else (None, torch.zeros_like(state))
            start_err = (starts[:, c] - want).abs().max().item()
            scale = max(1.0, py.float().abs().max().item())
            sscale = max(1.0, pstate.abs().max().item())
            tol = TOL[dtype] * (scale if dtype == torch.float32 else 1.0)
            row = {"shape": [b, s, h, p, g, n], "chunk": chunk, "pad": pad,
                   "dtype": str(dtype), "max_abs_err": err,
                   "state_max_abs_err": serr, "start_max_abs_err": start_err,
                   "y_scale": scale, "tol": tol,
                   "state_tol": TOL[torch.float32] * sscale}
            rows.append(row)
            print(f"[ssd_scan] {row}")
            assert err <= row["tol"] and serr <= row["state_tol"], row
            assert start_err <= row["state_tol"], row
    main = ssd_timings(gen, 8, 32, 32)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:61",
            "launches": None, **main,
            "library_call": "none: no one PyTorch call computes the SSD "
                            "scan",
            "long": ssd_timings(gen, 8, 2048, 256), "cases": rows}


def ssd_timings(gen, b, s, chunk) -> dict:
    """bf16 at mamba2-1.3b's widths (H64 P64 G1 N128), with both bounds."""
    dtype = torch.bfloat16
    args = ssd_inputs(gen, b, s, 64, 64, 1, 128, dtype)
    y, state = ssd_scan(*args, chunk=chunk)
    py, pstate = ref.ssd_scan_ref(*args, chunk=chunk)
    n_bytes, n_ops = ssd_work(*args, chunk)
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
    return {"shape": [b, s, 64, 64, 1, 128], "chunk": chunk, "dtype": "bf16",
            "max_abs_err": (y.float() - py.float()).abs().max().item(),
            "state_max_abs_err": (state - pstate).abs().max().item(),
            "ms": time_ms(lambda: ssd_scan(*args, chunk=chunk)),
            "plain_ms": time_ms(lambda: ref.ssd_scan_ref(*args, chunk=chunk),
                                10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": n_ops / PEAK_OPS_PER_S[dtype] * 1e3,
            "gflop": n_ops / 1e9, "mbytes": n_bytes / 1e6,
            "library_ms": None}


# (B, S, H, P, G, N, chunk, padded tail, final-state gradient): phase 6's
# training shape of mamba2-1.3b (B4 S1024), the same at a shorter length,
# and the edges
SSD_BWD_CASES = [(4, 1024, 64, 64, 1, 128, 256, 0, False),
                 (2, 512, 64, 64, 1, 128, 256, 0, False),
                 (2, 1024, 16, 64, 1, 128, 256, 24, True),
                 (2, 96, 4, 32, 4, 64, 32, 0, True),
                 (2, 300, 8, 64, 8, 32, 100, 0, False),
                 (2, 256, 16, 64, 2, 64, 64, 0, True),
                 (3, 64, 4, 32, 2, 32, 64, 0, False),
                 (2, 6, 4, 64, 1, 128, 6, 0, True)]
# the backward against its plain version, relative to each gradient's
# largest value: f32 by summation order and the exponents of the segment
# differences (|cum| reaches about 2100 at A = -64 over 256 tokens, about
# 1.3e-4 lost in each exponent), which ddt and dA carry through the
# reverse cumsum of dcum times A: 1e-3 for those two, 1e-4 for the rest;
# bf16 by one rounding of the bf16 gradients, and of the scores
# (dy.x) dt e^{cum_l - cum_s} and (C.B) e^{cum_l - cum_s} before their
# products on the tensor cores (tests/test_torch_ssd_rounding.py)
SSD_BWD_TOL = {torch.float32: {"dx": 1e-4, "ddt": 1e-3, "da": 1e-3,
                               "dB": 1e-4, "dC": 1e-4},
               torch.bfloat16: dict.fromkeys(("dx", "ddt", "da", "dB", "dC"),
                                             2e-2)}


def check_ssd_scan_bwd(gen) -> dict:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, p, g, n, chunk, pad, final in SSD_BWD_CASES:
            x, dt, a, bm, cm = ssd_inputs(gen, b, s, h, p, g, n, dtype, pad)
            dy = randn(gen, b, s, h, p, dtype=dtype)
            ds = randn(gen, b, h, p, n, dtype=torch.float32) if final \
                else None
            _, _, starts = ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                    states=True)
            got = ssd_scan_bwd(x, dt, a, bm, cm, dy, ds, starts, chunk=chunk)
            torch.cuda.synchronize()
            want = ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, ds,
                                        chunk=chunk)
            errs = {k: rel_err(u, v) for k, u, v in
                    zip(("dx", "ddt", "da", "dB", "dC"), got, want)}
            row = {"shape": [b, s, h, p, g, n], "chunk": chunk, "pad": pad,
                   "final_state_grad": final, "dtype": str(dtype),
                   "grad_rel_err": errs, "tol": SSD_BWD_TOL[dtype]}
            rows.append(row)
            print(f"[ssd_scan_bwd] {row}")
            assert all(errs[k] <= SSD_BWD_TOL[dtype][k] for k in errs), row
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "none: the TPU package differentiates ssd_chunked "
                        "(src/repro/models/ssm.py:73); backward of "
                        "src/repro/kernels/ssd_scan.py:61",
            "launches": None, **ssd_bwd_timings(gen, 4, 1024, 256),
            "library_call": "none: no one PyTorch call computes the SSD "
                            "backward (plain_ms is the yardstick)",
            "cases": rows}


def ssd_bwd_timings(gen, b, s, chunk) -> dict:
    """bf16 at mamba2-1.3b's training shape (B4 S1024, H64 P64 G1 N128),
    and two launches on the same inputs, which must give the same bits."""
    dtype = torch.bfloat16
    x, dt, a, bm, cm = ssd_inputs(gen, b, s, 64, 64, 1, 128, dtype)
    dy = randn(gen, b, s, 64, 64, dtype=dtype)
    _, _, starts = ssd_scan(x, dt, a, bm, cm, chunk=chunk, states=True)
    one = ssd_scan_bwd(x, dt, a, bm, cm, dy, None, starts, chunk=chunk)
    two = ssd_scan_bwd(x, dt, a, bm, cm, dy, None, starts, chunk=chunk)
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip(one, two))
    print(f"[ssd_scan_bwd] bit-identical relaunch: {same}")
    assert same
    want = ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, None, chunk=chunk)
    errs = {k: rel_err(u, v) for k, u, v in
            zip(("dx", "ddt", "da", "dB", "dC"), one, want)}
    print(f"[ssd_scan_bwd] timed shape grad_rel_err: {errs}")
    assert all(errs[k] <= SSD_BWD_TOL[dtype][k] for k in errs), errs
    n_bytes, n_ops = ssd_bwd_work(x, dt, a, bm, cm, chunk)
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
    return {"shape": [b, s, 64, 64, 1, 128], "chunk": chunk, "dtype": "bf16",
            "max_abs_err": max((u.float() - v.float()).abs().max().item()
                               for u, v in zip(one, want)),
            "grad_rel_err": errs, "tol": SSD_BWD_TOL[dtype],
            "bit_identical_relaunch": same,
            "ms": time_ms(lambda: ssd_scan_bwd(x, dt, a, bm, cm, dy, None,
                                               starts, chunk=chunk), 20),
            "plain_ms": time_ms(lambda: ref.ssd_scan_bwd_ref(
                x, dt, a, bm, cm, dy, None, chunk=chunk), 5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": n_ops / PEAK_OPS_PER_S[dtype] * 1e3,
            "library_ms": None}


def check_expert_gemm(gen) -> dict:
    # (E, C, d, f): one qwen2-moe decode step's gate/up and down products
    # (dropless C = the 8 requests), the routing prefix's capacity (21 of
    # 256 tokens) and a long prefill's (16 groups of 85), each timed in
    # bf16; then the edges of the bf16 tensor-core tiling: C 13 and 1
    # (N 16 and 8), C 300 and 200 (three tiles of 128, one of 256, on two
    # warpgroups), d and f not multiples of 64, f not a multiple of 8 (no
    # TMA: the CUDA-core kernel), and C 30, 40, 60, 90, 150 (N 32, 48, 64,
    # 96, 192), so that bf16 reaches every wgmma width
    timed = [(60, 8, 2048, 1408), (60, 8, 1408, 2048), (60, 21, 2048, 1408),
             (60, 1360, 2048, 1408)]
    cases = timed + [(3, 13, 200, 72), (2, 1, 136, 64), (2, 300, 200, 136),
                     (2, 200, 136, 264), (3, 13, 200, 70), (2, 30, 136, 72),
                     (2, 40, 200, 136), (2, 60, 136, 200), (2, 90, 200, 72),
                     (2, 150, 136, 136)]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for e, c, d, f in cases:
            # outputs about N(0, 1/4): below 4, where TOL holds in bf16
            xe = randn(gen, e, c, d, dtype=torch.float32).mul_(
                0.5 * d ** -0.5).to(dtype)
            w = randn(gen, e, d, f, dtype=dtype)
            out = expert_gemm(xe, w)
            torch.cuda.synchronize()
            plain = ref.expert_gemm_ref(xe, w)
            err = (out.float() - plain.float()).abs().max().item()
            row = {"shape": [e, c, d, f], "dtype": str(dtype),
                   "max_abs_err": err, "tol": TOL[dtype]}
            if dtype == torch.bfloat16 and (e, c, d, f) in timed:
                row.update(gemm_timings(xe, w, out, plain))
            rows.append(row)
            print(f"[expert_gemm] {row}")
            assert err <= TOL[dtype], row
    main = {k: v for k, v in rows[0].items() if k != "tol"}
    return {"name": "expert_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:38",
            "launches": None, **main, "library_call": "torch.bmm",
            "cases": rows}


def gemm_timings(xe, w, out, plain) -> dict:
    e, c, d = xe.shape
    bound_ms, bound_by = bound(nbytes(xe, w, out), 2.0 * e * c * d *
                               w.shape[-1], xe.dtype)
    return {"ms": time_ms(lambda: expert_gemm(xe, w)),
            "plain_ms": time_ms(lambda: ref.expert_gemm_ref(xe, w), 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lambda: torch.bmm(xe, w))}


# (E, C, d, f): the token MoE's training products of qwen2-moe-a2.7b
# (4 groups of capacity 85 folded into C 340; gate/up d 2048 -> f 1408,
# down the other way), timed in bf16; then the tiling's edges: C 1360,
# the ragged E2 C33 d50 f30 (the CUDA-core kernel), C 1, d and f not
# multiples of 64 (MN-major B tiles of 64 + a tail)
GEMM_BWD_TIMED = [(60, 340, 2048, 1408), (60, 340, 1408, 2048)]
GEMM_BWD_CASES = GEMM_BWD_TIMED + [(60, 1360, 2048, 1408), (2, 33, 50, 30),
                                   (3, 13, 200, 72), (2, 1, 136, 64),
                                   (2, 300, 200, 136), (2, 90, 72, 200)]


def check_expert_gemm_bwd(gen) -> list:
    rows, timed = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        for e, c, d, f in GEMM_BWD_CASES:
            # dX = dY W^T and dW = X^T dY both about N(0, 1/4): below 4,
            # where TOL holds in bf16, and large against TOL
            xe = randn(gen, e, c, d, dtype=torch.float32).mul_(
                c ** -0.5).to(dtype)
            w = randn(gen, e, d, f, dtype=torch.float32).mul_(
                f ** -0.5).to(dtype)
            dy = randn(gen, e, c, f, dtype=torch.float32).mul_(0.5).to(dtype)
            dx, dw = expert_gemm_dx(dy, w, xe), expert_gemm_dw(xe, dy, w)
            torch.cuda.synchronize()
            pdx, pdw = ref.expert_gemm_bwd_ref(xe, w, dy)
            errs = {"dx": (dx.float() - pdx.float()).abs().max().item(),
                    "dw": (dw.float() - pdw.float()).abs().max().item()}
            std = {"dx": pdx.float().std().item(),
                   "dw": pdw.float().std().item()}
            row = {"shape": [e, c, d, f], "dtype": str(dtype),
                   "max_abs_err": errs, "plain_std": std, "tol": TOL[dtype]}
            rows.append(row)
            print(f"[expert_gemm_bwd] {row}")
            assert max(errs.values()) <= TOL[dtype], row
            assert min(std.values()) > 0.2, row
            if dtype == torch.bfloat16 and (e, c, d, f) in GEMM_BWD_TIMED:
                timed[(e, c, d, f)] = gemm_bwd_timings(xe, w, dy, errs)
    out = []
    for name, key in (("expert_gemm_dx", "dx"), ("expert_gemm_dw", "dw")):
        shape = GEMM_BWD_TIMED[0]
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": "none: the TPU package differentiates the expert "
                        "einsum; backward of src/repro/kernels/moe_gmm.py:38",
            "launches": None, "shape": list(shape), "dtype": "bf16",
            **timed[shape][key],
            "down_projection": timed[GEMM_BWD_TIMED[1]][key],
            "library_call": "torch.bmm(dy, w^T)" if key == "dx"
                            else "torch.bmm(x^T, dy)"})
    out[0]["cases"] = rows
    return out


def gemm_bwd_timings(xe, w, dy, errs) -> dict:
    """dX and dW in bf16: each kernel, the plain backward (which computes
    both), the bound, and one torch.bmm on the same inputs; two launches
    of each give the same bits."""
    e, c, d = xe.shape
    f = w.shape[-1]
    dx, dw = expert_gemm_dx(dy, w, xe), expert_gemm_dw(xe, dy, w)
    same = bool(torch.equal(dx, expert_gemm_dx(dy, w, xe))
                and torch.equal(dw, expert_gemm_dw(xe, dy, w)))
    print(f"[expert_gemm_bwd] bit-identical relaunch: {same}")
    assert same
    plain_ms = time_ms(lambda: ref.expert_gemm_bwd_ref(xe, w, dy), 10)
    wt, xt = w.transpose(1, 2), xe.transpose(1, 2)
    out = {}
    for key, fn, lib, n_bytes in (
            ("dx", lambda: expert_gemm_dx(dy, w, xe),
             lambda: torch.bmm(dy, wt), nbytes(dy, w, xe)),
            ("dw", lambda: expert_gemm_dw(xe, dy, w),
             lambda: torch.bmm(xt, dy), nbytes(xe, dy, w))):
        bound_ms, bound_by = bound(n_bytes, 2.0 * e * c * d * f, xe.dtype)
        out[key] = {"max_abs_err": errs[key], "ms": time_ms(fn),
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": time_ms(lib),
                    "bit_identical_relaunch": same}
    return out


# ---------------------------------------------------------------------------
# Phase 2, the families' shapes (phase 11's)
# ---------------------------------------------------------------------------
# (family, E, d, f, {kind: C}): the expert GEMM's capacities in phase 11:
# a decode step of the requests on one path (dropless C = their number:
# moonshot-v1-16b-a3b serves its 8 on its one path, jamba-v0.1-52b's
# router splits them 4 and 4 over its two; ``family_launches`` fails the
# run if the serving run launched no decode at that C), the routing call
# over their 32-token prefixes (moonshot-v1-16b-a3b: int(256 * 6 * 1.25 / 64)
# = 30; jamba-v0.1-52b: int(256 * 2 * 1.25 / 16) = 40), the 48-token
# prefill of the kernels-vs-plain check (45; 60) and a group of 1024
# tokens, as the router's 64 prefixes and the gradient check's two
# 1024-token documents give (two groups of 120; of 160, folded into C)
GEMM_FAMILIES = (
    ("moonshot-v1-16b-a3b", 64, 2048, 1408,
     {"decode": 8, "routing": 30, "prefill": 45, "train": 240}),
    ("jamba-v0.1-52b", 16, 4096, 14336,
     {"decode": 4, "routing": 40, "prefill": 60, "train": 320}),
    # served only: int(256 * 8 * 1.25 / 128) = 20 at routing, 30 at the
    # prefill check's 384 tokens
    ("qwen3-moe-235b-a22b", 128, 4096, 1536,
     {"decode": 8, "routing": 20, "prefill": 30}))
GEMM_TIMED = ("decode", "routing")


def gemm_row(name: str, family: str, kind: str, shape, main: dict,
             down: dict) -> dict:
    return {"name": f"{name}:{family}:{kind}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:38" if name ==
            "expert_gemm" else "none: the TPU package differentiates the "
            "expert einsum; backward of src/repro/kernels/moe_gmm.py:38",
            "launches": None, "shape": list(shape), "dtype": "bf16",
            **main, "library_call": {"expert_gemm": "torch.bmm",
                                     "expert_gemm_dx": "torch.bmm(dy, w^T)",
                                     "expert_gemm_dw": "torch.bmm(x^T, dy)"
                                     }[name],
            "down_projection": down}


def check_gemm_families(gen) -> list:
    """The expert GEMM and its dX / dW at phase 11's capacities, each
    product's gate/up (d -> f) and down (f -> d) shapes, against their
    plain versions in bf16 and f32; the forward timed at the decode and
    routing capacities, dX and dW at the training capacity."""
    rows, cases = [], []
    for family, e, d, f, caps in GEMM_FAMILIES:
        for kind, c in caps.items():
            timed = {}
            for dd, ff in ((d, f), (f, d)):
                for dtype in (torch.bfloat16, torch.float32):
                    xe = randn(gen, e, c, dd, dtype=torch.float32).mul_(
                        0.5 * dd ** -0.5).to(dtype)
                    w = randn(gen, e, dd, ff, dtype=dtype)
                    out = expert_gemm(xe, w)
                    torch.cuda.synchronize()
                    plain = ref.expert_gemm_ref(xe, w)
                    err = (out.float() - plain.float()).abs().max().item()
                    case = {"shape": [e, c, dd, ff], "dtype": str(dtype),
                            "max_abs_err": err, "tol": TOL[dtype]}
                    print(f"[expert_gemm {family}] {case}")
                    cases.append(case)
                    assert err <= TOL[dtype], case
                    if dtype == torch.bfloat16 and kind in GEMM_TIMED:
                        timed[dd] = {"max_abs_err": err,
                                     **gemm_timings(xe, w, out, plain)}
                    if kind in ("decode", "train"):
                        xb = xe.float().mul_(2 * c ** -0.5 * dd ** 0.5
                                             ).to(dtype)
                        wb = w.float().mul_(ff ** -0.5).to(dtype)
                        dy = randn(gen, e, c, ff, dtype=torch.float32
                                   ).mul_(0.5).to(dtype)
                        dx = expert_gemm_dx(dy, wb, xb)
                        dw = expert_gemm_dw(xb, dy, wb)
                        torch.cuda.synchronize()
                        pdx, pdw = ref.expert_gemm_bwd_ref(xb, wb, dy)
                        errs = {
                            "dx": (dx.float() - pdx.float()).abs().max()
                            .item(),
                            "dw": (dw.float() - pdw.float()).abs().max()
                            .item()}
                        case = {"shape": [e, c, dd, ff], "dtype": str(dtype),
                                "backward_max_abs_err": errs,
                                "tol": TOL[dtype]}
                        print(f"[expert_gemm_bwd {family}] {case}")
                        cases.append(case)
                        assert max(errs.values()) <= TOL[dtype], case
                        if dtype == torch.bfloat16 and kind == "train":
                            timed[("bwd", dd)] = gemm_bwd_timings(
                                xb, wb, dy, errs)
            if kind in GEMM_TIMED:
                rows.append(gemm_row("expert_gemm", family, kind,
                                     (e, c, d, f), timed[d], timed[f]))
            if kind == "train":
                for name, key in (("expert_gemm_dx", "dx"),
                                  ("expert_gemm_dw", "dw")):
                    rows.append(gemm_row(name, family, kind, (e, c, d, f),
                                         timed[("bwd", d)][key],
                                         timed[("bwd", f)][key]))
    rows[0]["cases"] = cases
    return rows


def decode_cases(gen, b, h, kh, d, label: str) -> list:
    """flash decode against its plain version over phase 3's 80-token
    cache at the last step and mid-prompt, bf16 and f32, int8 or not."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for int8 in (False, True):
            for ci in ([CACHE_LEN - 1] * b, list(range(0, 80, 10))[:b]):
                q = randn(gen, b, h, d, dtype=dtype)
                kc, vc = (randn(gen, b, CACHE_LEN, kh, d, dtype=dtype)
                          for _ in range(2))
                cit = torch.tensor(ci, dtype=torch.int32, device="cuda")
                ks = vs = None
                if int8:
                    (kc, ks), (vc, vs) = quantize(kc), quantize(vc)
                out = flash_decode(q, kc, vc, cit, k_scale=ks, v_scale=vs)
                torch.cuda.synchronize()
                plain = ref.flash_decode_ref(q, kc, vc, cit, k_scale=ks,
                                             v_scale=vs)
                err = (out.float() - plain.float()).abs().max().item()
                case = {"shape": [b, h, kh, d, CACHE_LEN],
                        "dtype": str(dtype), "int8": int8,
                        "max_abs_err": err, "tol": TOL[dtype]}
                print(f"[flash_decode {label}] {case}")
                cases.append(case)
                assert err <= TOL[dtype], case
    return cases


def check_families_attention(gen) -> list:
    """flash decode at the GQA families' decode (H32 KH8 D128 over phase
    3's 80-token cache: B8, the requests of a family served on one path,
    and B4, those of qwen3-8b's and jamba-v0.1-52b's two paths, which
    their routers split 4 and 4; at the last step and mid-prompt; bf16 and
    f32, int8 or not), and the LSE forward, dK/dV and dQ at the dense
    baseline's training shape (B8 S1024 H16 D128)."""
    fds = []
    for b in (REQUESTS, REQUESTS // 2):
        rows = decode_cases(gen, b, 32, 8, 128, "G4")
        fds.append({
            "name": f"flash_decode:gqa-d128:b{b}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:103",
            "launches": None,
            **fd_timings(gen, b, 32, 128, CACHE_LEN, [CACHE_LEN - 1] * b,
                         kh=8),
            "library_call": "F.scaled_dot_product_attention(attn_mask="
                            "ring mask, enable_gqa=True)", "cases": rows})
    train = training_attention_timings(gen, TRAIN_BATCH, DOC_LEN, 16, 128)
    for r in train:
        r["name"] += ":dipaco-dense-1b"
    # the timed rows hold bf16; f32 at the same shape
    train[0]["cases"] = [check_training_case(gen, TRAIN_BATCH, DOC_LEN, 16,
                                             16, 128, True, None,
                                             torch.float32)]
    return [*fds, *train]


# (family, H, KH, D, the decode batches its paths see in phase 11): the
# published heads of the last three families.  gemma-2b's router splits
# its 8 requests over its 2 paths; the others serve all 8 on one path.
# ``family_launches`` fails the run if a row's batch never decoded there.
WIDE_HEADS = (("gemma-2b", 8, 1, 256, (3, 5)),
              ("nemotron-4-340b", 96, 8, 192, (REQUESTS,)),
              ("qwen3-moe-235b-a22b", 64, 4, 128, (REQUESTS,)))


def check_wide_decode(gen) -> list:
    """flash decode at the last three families' query groups and head
    dims (G 8 D 256, G 12 D 192, G 16 D 128) over phase 3's 80-token
    cache, at the last step and mid-prompt, bf16 and f32, int8 or not,
    at B8 and at each batch a path sees; timed (bf16, eager and from a
    graph, beside SDPA ``enable_gqa``) at those batches, at B8 and over
    a wrapped 2048-token ring at B8."""
    rng = np.random.default_rng(11)
    rows = []
    for family, h, kh, d, batches in WIDE_HEADS:
        cases = [case for b in sorted({REQUESTS, *batches})
                 for case in decode_cases(gen, b, h, kh, d, family)]
        for i, b in enumerate(batches):
            row = {"name": f"flash_decode:{family}:b{b}", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/"
                             "decode_attention.cu",
                   "replaces": "src/repro/kernels/decode_attention.py:103",
                   "launches": None,
                   **fd_timings(gen, b, h, d, CACHE_LEN,
                                [CACHE_LEN - 1] * b, kh=kh),
                   "library_call": "F.scaled_dot_product_attention("
                                   "attn_mask=ring mask, enable_gqa=True)"}
            if i == 0:
                if REQUESTS not in batches:
                    row["b8"] = fd_timings(gen, REQUESTS, h, d, CACHE_LEN,
                                           [CACHE_LEN - 1] * REQUESTS, kh=kh)
                row["long"] = fd_timings(
                    gen, REQUESTS, h, d, 2048,
                    rng.integers(0, 3 * 2048, REQUESTS).tolist(), kh=kh)
                row["cases"] = cases
            print(f"[flash_decode {family}] timed {row}", flush=True)
            rows.append(row)
    return rows


def check_wide_attention(gen) -> list:
    """The forward (both dtypes) at the last three families' routing
    calls (B8 S32: gemma H8 KH1 D256, nemotron H96 KH8 D192, qwen3-moe
    H64 KH4 D128), at B2 S2048 for the two new head dims, and at ragged,
    windowed edges of D 192 and 256; timed in bf16 at the routing call
    and (D 192 / 256) at B2 S2048, beside SDPA causal ``enable_gqa``."""
    rows = []
    for family, h, kh, d, _ in WIDE_HEADS:
        shapes = [(8, 32, h, kh, d, None)]
        if d > 128:
            shapes += [(2, 2048, h, kh, d, None), (1, 333, h, kh, d, 100),
                       (2, 65, h, kh, d, 7)]
        cases = []
        for dtype in (torch.bfloat16, torch.float32):
            for b, s, hh, kk, dd, w in shapes:
                q = randn(gen, b, s, hh, dd, dtype=dtype)
                k, v = (randn(gen, b, s, kk, dd, dtype=dtype)
                        for _ in range(2))
                out = flash_attention(q, k, v, causal=True, window=w)
                torch.cuda.synchronize()
                plain = ref.flash_attention_ref(q, k, v, causal=True,
                                                window=w)
                err = (out.float() - plain.float()).abs().max().item()
                case = {"shape": [b, s, hh, kk, dd], "window": w,
                        "dtype": str(dtype), "max_abs_err": err,
                        "tol": TOL[dtype]}
                print(f"[flash_attention {family}] {case}")
                cases.append(case)
                assert err <= TOL[dtype], case
                del q, k, v, out, plain
        row = {"name": f"flash_attention:{family}:routing", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:81",
               "launches": None, **fa_timings(gen, 8, 32, h, d, kh=kh),
               "library_call": "F.scaled_dot_product_attention("
                               "is_causal=True, enable_gqa=True)",
               "cases": cases}
        if d > 128:
            row["long"] = fa_timings(gen, 2, 2048, h, d, kh=kh)
        print(f"[flash_attention {family}] timed {row}", flush=True)
        rows.append(row)
    return rows


# gemma-2b's batch in phase 11's training.  Its 2.51 G parameters are
# 5.0 GB in bf16; the vector trainer's f32 global copy, AdamW moments and
# outer momentum add 37.3 GiB, and the f32 log-softmax over 256000 words
# is 4.2 GB at B4 S1024, its gradient as much again.  At batch 8 the
# step ran out of the card's 79.18 GiB in the backward (74.01 GiB
# allocated, 7.81 GiB asked for), so the batch is cut to 4; blocks and
# widths stay whole
GEMMA_TRAIN_BATCH = 4
# gemma-2b's peak learning rate.  At the other families' 2e-3 its loss
# rises from the second phase's first step to its second, 12.02 -> 14.81
# (10.75 -> 21.34 warmed up over tau), and the second phase's mean is
# above the first's; the plain attention gives the same losses to 0.06
# (tools/gemma_lr_probe.py on the H100), so the rise is not the kernels'.
# At 5e-4 the phase means fall, 13.04 -> 11.34
GEMMA_PEAK_LR = 5e-4
# (family, B, S, H, KH, D): where phase 11's main path takes the attention
# backward at the last three families' heads: gemma-2b's training batch,
# and the gradient checks' batch of nemotron-4-340b (G 12 at D 192) and
# qwen3-moe-235b-a22b (G 16 at D 128)
WIDE_TRAIN = (("gemma-2b", GEMMA_TRAIN_BATCH, DOC_LEN, 8, 1, 256),
              ("nemotron-4-340b", 2, DOC_LEN, 96, 8, 192),
              ("qwen3-moe-235b-a22b", 2, DOC_LEN, 64, 4, 128))
# (B, S, H, KH, D, window): ragged S and windows at D 192 and 256, over
# the column chunks of the bf16 dK/dV and the 32-row f32 tiles of D 256
WIDE_TRAIN_EDGES = ((1, 333, 24, 2, 192, 100), (1, 65, 12, 1, 192, None),
                    (2, 200, 8, 1, 256, None), (2, 65, 8, 1, 256, 7))


def check_wide_training(gen) -> list:
    """The LSE forward, dK/dV and dQ at WIDE_TRAIN's shapes: held to their
    plain versions in bf16 (timed beside their bound, their plain version
    and SDPA ``enable_gqa``, and both backward kernels relaunched for
    identical bits) and in f32; gemma-2b's heads also at batch 8; and
    WIDE_TRAIN_EDGES in both dtypes."""
    rows = []
    for family, b, s, h, kh, d in WIDE_TRAIN:
        train = training_attention_timings(gen, b, s, h, d, kh=kh)
        for r in train:
            r["name"] += f":{family}"
        train[0]["cases"] = [check_training_case(gen, b, s, h, kh, d, True,
                                                 None, torch.float32)]
        if family == "gemma-2b":
            # also at TRAIN_BATCH (8), the batch every other family trains
            # at, which gemma's training leaves only for want of memory
            train[0]["cases"] += [
                check_training_case(gen, TRAIN_BATCH, s, h, kh, d, True,
                                    None, dt)
                for dt in (torch.bfloat16, torch.float32)]
        print(f"[train_attention {family}] timed {train}", flush=True)
        rows += train
    rows[0]["edges"] = [check_training_case(gen, b, s, h, kh, d, True, w, dt)
                        for dt in (torch.bfloat16, torch.float32)
                        for b, s, h, kh, d, w in WIDE_TRAIN_EDGES]
    return rows


# ---------------------------------------------------------------------------
# Phase 3: serving at full width
# ---------------------------------------------------------------------------
class CheckedEngine(PathServingEngine):
    """The one-shot engine, keeping a device-side flag of whether every
    decode step's logits were finite (read once, after generate), and
    counting its decode steps and routing-feature calls.  The kernels'
    launches are kept apart by call in ``launches_by_call``: a decode step
    of B requests under ``"decode:B"``, a feature call over N tokens under
    ``"features:N"``.  Each decode step is timed by CUDA events around it
    (host clock off the card), read by ``step_ms``: the engine runs as it
    would, with no synchronize added."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.finite = torch.ones((), dtype=torch.bool, device=self.device)
        self.decodes = self.feature_calls = 0
        self.launches_by_call, self.step_marks = {}, []

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _tally(self, call: str, before: dict) -> None:
        seen = self.launches_by_call.setdefault(call, dict.fromkeys(before,
                                                                    0))
        for k, n in counts().items():
            seen[k] += n - before[k]

    def _decode(self, params, tok, cache, idx):
        before, start = counts(), self._mark()
        logits, cache = super()._decode(params, tok, cache, idx)
        self.step_marks.append((start, self._mark()))
        self.finite = self.finite & torch.isfinite(logits).all()
        self.decodes += 1
        self._tally(f"decode:{tok.shape[0]}", before)
        return logits, cache

    def _feats(self, tokens):
        before = counts()
        self.feature_calls += 1
        z = super()._feats(tokens)
        self._tally(f"features:{np.asarray(tokens).size}", before)
        return z

    def step_ms(self) -> list:
        """Each decode step's milliseconds since the marks were cleared
        (synchronizes once)."""
        sync(self.device.type)
        return [a.elapsed_time(b) if self.device.type == "cuda"
                else (b - a) * 1e3 for a, b in self.step_marks]

    def clear(self) -> None:
        self.decodes = self.feature_calls = 0
        self.launches_by_call, self.step_marks = {}, []


KERNELS = (flash_attention, flash_decode, flash_attention_lse,
           flash_attention_dkv, flash_attention_dq, router_assign, ssd_scan,
           ssd_scan_bwd, expert_gemm, expert_gemm_dx, expert_gemm_dw)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def expected_launches(cfg, feature_calls: int, decodes: int) -> dict:
    """What the serving path launches: per routing-feature call (the
    cache-free forward) flash attention once per attention block, the
    SSD scan once per Mamba block and the expert GEMM once per product of
    each MoE block; per decode step flash decode once per attention block
    and the expert GEMM likewise."""
    blocks = [spec for spec in cfg.pattern] * cfg.pattern_repeats
    attn = sum(b.mixer == "attn" for b in blocks)
    mamba = sum(b.mixer == "mamba" for b in blocks)
    moe = sum(b.mlp == "moe" for b in blocks)
    gemms = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return {"flash_attention": attn * feature_calls,
            "flash_decode": attn * decodes,
            "ssd_scan": mamba * feature_calls,
            "expert_gemm": gemms * moe * (feature_calls + decodes)}


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def reset_peak(dev: str) -> None:
    sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gib(dev: str):
    """The peak allocated device memory since ``reset_peak``; None off
    the card."""
    return torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev == "cuda" else None


def serve(cfg, num_paths: int = NUM_PATHS,
          profile_prompt: int = PROMPT_LEN, *, reroute: bool = True,
          dev: str = "cuda") -> dict:
    """The serving path at full width: random paths from seeds, a router
    over path 0's prefix features, generate plain and (with ``reroute``)
    re-routed; checks
    tokens, finiteness and (on the card) every kernel's launch count, by
    decode steps and by feature calls, then (on the card) profiles a
    generate of ``profile_prompt``-token prompts."""
    reset_peak(dev)
    t_init = time.perf_counter()
    paths = [api.init_model(cfg, seed=p, device=dev)
             for p in range(num_paths)]
    sync(dev)
    t_init = time.perf_counter() - t_init
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=PROMPT_LEN, seed=0)
    # router from generated weights over the first path's prefix features
    feats = prefix_features(paths[0], cfg, corpus.sample_documents(64,
                                                                   seed=1))
    gen = torch.Generator(device=dev).manual_seed(1234)
    router = DiscriminativeRouter(
        w=torch.randn((cfg.d_model, num_paths), generator=gen,
                      device=dev),
        b=torch.zeros(num_paths, device=dev), mu=feats.mean(0),
        sigma=torch.clamp_min(feats.std(0), 1e-6))
    prompts = corpus.sample_documents(REQUESTS, seed=2)
    eng = CheckedEngine(cfg, paths, options=EngineOptions(
        router=router, cache_len=CACHE_LEN))
    # warm-up (cuBLAS handles, the kernels' first launches) on short prompts
    eng.generate(prompts[:, :8], max_new=2)
    sync(dev)
    runs = {"paths_init_s": t_init}
    passes = (("plain", 0), ("reroute", REROUTE_EVERY))[:1 + reroute]
    for name, every in passes:
        reset_counts()
        eng.clear()
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new=MAX_NEW, reroute_every=every)
        sync(dev)
        dt = time.perf_counter() - t0
        launched = counts()
        new = res.tokens[:, PROMPT_LEN:]
        assert res.tokens.shape == (REQUESTS, PROMPT_LEN + MAX_NEW)
        assert ((new >= 0) & (new < cfg.vocab_size)).all(), new
        want = expected_launches(cfg, eng.feature_calls, eng.decodes)
        got = {k: launched[k] for k in want}
        by_call = eng.launches_by_call
        if dev == "cuda":
            assert got == want, (name, got, want)
            assert all(launched[k] > 0 for k, v in want.items() if v), \
                launched
            for kind, calls in (("decode", eng.decodes),
                                ("features", eng.feature_calls)):
                want = expected_launches(
                    cfg, *((0, calls) if kind == "decode" else (calls, 0)))
                got = {k: sum(n[k] for c, n in by_call.items()
                              if c.startswith(kind)) for k in want}
                assert got == want, (name, kind, got, want)
        runs[name] = {"paths": res.paths.tolist(), "switches": res.switches,
                      "tokens_per_s": REQUESTS * MAX_NEW / dt,
                      "seconds": dt, "decode_steps": eng.decodes,
                      "decode_step_ms_median": float(np.median(
                          eng.step_ms())),
                      "feature_calls": eng.feature_calls,
                      "launches": launched,
                      # a copy: the profiled generate below adds to the
                      # engine's own
                      "launches_by_call": {c: dict(n)
                                           for c, n in by_call.items()}}
        print(f"[serve {cfg.name}] {name}: routed paths "
              f"{res.paths.tolist()}, switches {res.switches}, "
              f"{REQUESTS * MAX_NEW / dt:.1f} tok/s ({dt:.3f} s), "
              f"{eng.decodes} decode steps (median "
              f"{runs[name]['decode_step_ms_median']:.2f} ms), "
              f"{eng.feature_calls} feature calls, launches {launched}")
    assert bool(eng.finite), "non-finite logits during generate"
    if dev == "cuda":
        runs["device_busy_share"] = device_busy_share(
            eng, prompts[:, :profile_prompt])
    runs["peak_memory_gib"] = peak_gib(dev)
    print(f"[serve {cfg.name}] {num_paths} paths made in {t_init:.1f} s; "
          f"peak memory {runs['peak_memory_gib']} GiB")
    del eng, paths, feats, router
    free_memory()
    return runs


def free_memory():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def profiled(fn, top: int, key_averages: bool = False,
             tracked: tuple = ()) -> dict:
    """Device kernel time over wall time for one call of fn, from
    torch.profiler (CPU and CUDA activity); None where the profiler saw no
    device time.  The device events are summed by name from the raw trace:
    ``key_averages`` builds the host-side call tree first, which took
    80-120 s a serving window at these sizes.  With ``key_averages`` the
    window's device time is also summed from ``key_averages()`` (the self
    time of its CUDA events), to hold the two yardsticks side by side.
    The top kernels are summed by the first 60 characters of their names;
    ``tracked`` names kernels whose device time is summed whatever their
    rank (every kernel whose name holds the string)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns()
    device_us = sum(by_name.values()) / 1e3
    short: dict = {}
    for name, ns in by_name.items():
        short[name[:60]] = short.get(name[:60], 0) + ns
    ranked = sorted(short.items(), key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
           "busy_share": device_us / wall_us if device_us else None,
           "top_kernels_ms": {k: ns / 1e6 for k, ns in ranked},
           "tracked_ms": {t: sum(ns for n, ns in by_name.items() if t in n)
                          / 1e6 for t in tracked},
           "processing_s": time.perf_counter() - t0}
    if key_averages:
        t0 = time.perf_counter()
        out["device_ms_key_averages"] = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out["key_averages_s"] = time.perf_counter() - t0
    return out


def device_busy_share(eng, prompts) -> dict:
    """Device kernel time over wall time for one short generate (the 8
    requests, 4 new tokens)."""
    out = profiled(lambda: eng.generate(prompts, max_new=4), 6)
    print(f"[profile] {out}")
    return out


class ForcedExperts:
    """Teacher forcing of the MoE router for a kernels-vs-plain check.
    While active, every router call of the kernels' run (``run =
    "kernels"``) records its top-k experts; the plain run (``run =
    "plain"``, the same calls in the same order) takes the kernels' run's
    experts in place of its own, with gates from its own router
    probabilities, so a near-tie that the two runs break differently
    changes no token's mixture.  Each run's own choices are kept, and
    ``flips()`` counts, call by call, the token choices whose expert set
    differs."""

    def __init__(self):
        self.own = {"kernels": [], "plain": []}
        self.run = None
        self._topk = moe_layer._router_topk

    def __enter__(self):
        def forced(p, m, x):
            gates, idx, aux = self._topk(p, m, x)
            own = self.own[self.run]
            own.append(idx)
            if self.run == "plain":
                idx = self.own["kernels"][len(own) - 1]
                logits = x.float() @ p["router"].to(x.dtype).float()
                g = torch.softmax(logits, dim=-1).gather(-1, idx)
                gates = (g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
                         ).to(x.dtype)
            return gates, idx, aux
        moe_layer._router_topk = forced
        return self

    def __exit__(self, *exc):
        moe_layer._router_topk = self._topk

    def flips(self) -> list:
        """-> token choices whose expert set differs, call by call."""
        k, p = self.own["kernels"], self.own["plain"]
        assert len(k) == len(p)
        return [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(k, p)]


def cut_layers(cfg, depth):
    """cfg with ``depth`` blocks (an encoder-decoder: ``depth`` encoder
    and ``depth`` decoder blocks); widths stay.  None: as it is."""
    if depth is None:
        return cfg
    if cfg.encoder is not None:
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                      num_layers=depth))
    return cfg.replace(num_layers=depth)


def prefill_decode_parity(cfg, dtype: str, tol: float, *,
                          prompt_len: int = PROMPT_LEN - MAX_NEW,
                          batch: int = REQUESTS, depth=None,
                          extras=None, dev: str = "cuda") -> dict:
    """prefill + MAX_NEW decode steps through the kernels vs the same
    calls through the plain path (attn_impl="full": plain attention,
    ``ref.ssd_scan_ref``, einsum experts), same weights, the MoE router
    teacher-forced; ``depth`` cuts the number of blocks, widths stay.
    ``extras(params, cfg)`` adds entries to every call's batch (an
    encoder-decoder's ``enc_out`` and ``cross_kv``)."""
    t_start = time.perf_counter()
    cfg_k = cut_layers(cfg.replace(dtype=dtype), depth)
    cfg_p = cfg_k.replace(attn_impl="full")
    params = api.init_model(cfg_k, seed=7, device=dev)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=prompt_len + MAX_NEW, seed=3)
    toks = torch.as_tensor(corpus.sample_documents(batch), device=dev)
    s, cache_len = prompt_len, prompt_len + MAX_NEW
    worst = 0.0
    with torch.inference_mode(), ForcedExperts() as choices:
        extra = {} if extras is None else extras(params, cfg_k)
        choices.run = "kernels"
        lg_k, cache_k = api.prefill(params, cfg_k, {"tokens": toks[:, :s],
                                                    **extra}, cache_len)
        choices.run = "plain"
        lg_p, cache_p = api.prefill(params, cfg_p, {"tokens": toks[:, :s],
                                                    **extra}, cache_len)
        for t in range(MAX_NEW):
            assert torch.isfinite(lg_k).all()
            worst = max(worst, (lg_k.float() - lg_p.float()).abs().max()
                        .item())
            tok = toks[:, s + t:s + t + 1]
            ci = torch.full((batch,), s + t, dtype=torch.int32,
                            device=dev)
            choices.run = "kernels"
            lg_k, cache_k = api.serve_step(params, cfg_k,
                                           {"tokens": tok, **extra},
                                           cache_k, ci)
            choices.run = "plain"
            lg_p, cache_p = api.serve_step(params, cfg_p,
                                           {"tokens": tok, **extra},
                                           cache_p, ci)
        worst = max(worst, (lg_k.float() - lg_p.float()).abs().max().item())
    flips = choices.flips()
    moe_blocks = len(flips) // (1 + MAX_NEW)      # the prefill's calls
    out = {"max_abs_dlogit": worst, "blocks": cfg_k.num_layers, "tol": tol,
           "prompt": [batch, s],
           "max_abs_logit": lg_p.float().abs().max().item(),
           "expert_flips_unforced": sum(flips),
           "expert_choices": sum(a.shape[0] for a in choices.own["kernels"]),
           "prefill_flips_by_block": flips[:moe_blocks],
           "seconds": time.perf_counter() - t_start}
    print(f"[prefill+decode {cfg.name}] {dtype}: kernels vs plain max "
          f"|dlogit| {worst:.3e} (tol {tol:.3g}), {out}")
    assert worst <= tol, (cfg.name, dtype, out)
    del params, cache_k, cache_p
    free_memory()
    return out


# ---------------------------------------------------------------------------
# Phase 4: training at full width
# ---------------------------------------------------------------------------
class TimedStep:
    """Wraps a trainer's inner step: host time of each call (all workers)
    after synchronizing the device."""

    def __init__(self, fn, dev: str = "cuda"):
        self.fn, self.seconds, self.dev = fn, [], dev

    def __call__(self, *args):
        sync(self.dev)
        t0 = time.perf_counter()
        out = self.fn(*args)
        sync(self.dev)
        self.seconds.append(time.perf_counter() - t0)
        return out


def train(cfg) -> dict:
    """The quickstart pipeline through the port's entry points, counted
    from corpus to routed evaluation."""
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DOC_LEN, seed=0)
    t0 = time.perf_counter()
    docs = corpus.sample_documents(DOCS)
    val = corpus.sample_documents(64, seed=99)
    print(f"[train] corpus {docs.shape} in {time.perf_counter() - t0:.1f} s")
    base = api.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    feats = prefix_features(base, cfg, docs)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cents, assign, inertia = kmeans_fit(feats, TRAIN_PATHS,
                                        iters=KMEANS_ITERS, generator=gen)
    ds = shard_documents(docs, assign.cpu().numpy(), TRAIN_PATHS)
    print(f"[train] k-means shard sizes {ds.sizes.tolist()}, inertia "
          f"{float(inertia):.4g}")
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=TAU)
    tr = make_trainer(cfg, dcfg, ds, backend="vector", device="cuda",
                      base_params=base, batch_size=TRAIN_BATCH, peak_lr=2e-3,
                      warmup=TAU, total_steps=PHASES * TAU)
    timer = tr._step_fn = TimedStep(tr._step_fn)
    phases = []
    for ph in range(PHASES):
        m = tr.run_phase()
        phases.append({"mean_loss": m.mean_loss, "final_loss": m.final_loss,
                       "per_path_loss": m.per_path_loss.tolist()})
        print(f"[train] phase {ph}: {phases[-1]}")
    va, _ = kmeans_assign(prefix_features(base, cfg, val), cents)
    evaluated = tr.evaluate_routed(val, va.cpu().numpy())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    rerouted = train_rerouted(tr, cfg, base, cents, val, evaluated)
    peak = torch.cuda.max_memory_allocated()
    W = tr.num_workers
    step_s = float(np.median(timer.seconds)) / W
    out = {"phases": phases, "routed_eval": evaluated,
           "rerouted_eval": rerouted,
           "shard_sizes": ds.sizes.tolist(), "seconds": seconds,
           "inner_step_s_per_worker": step_s,
           "inner_step_s_all": timer.seconds,
           "tokens_per_s": TRAIN_BATCH * DOC_LEN / step_s,
           "peak_memory_gib": peak / 2 ** 30, "launches": launched}
    print(f"[train] {seconds:.1f} s from features to evaluation; inner step "
          f"{step_s * 1e3:.1f} ms per worker ({out['tokens_per_s']:.0f} "
          f"tok/s), peak memory {peak / 2 ** 30:.2f} GiB, routed eval "
          f"{evaluated}, launches {launched}")
    losses = [p["mean_loss"] for p in phases]
    assert all(np.isfinite(losses)) and np.isfinite(evaluated["nll"]), out
    assert losses[1] < losses[0], losses
    steps = W * TAU * PHASES                  # inner steps of all workers
    # with remat the backward recomputes each layer group's forward: the
    # LSE forward runs twice a block and worker step, dK/dV and dQ once
    forwards = 2 if cfg.remat else 1
    assert launched["flash_attention_lse"] == \
        forwards * cfg.num_layers * steps, launched
    for name in ("flash_attention_dkv", "flash_attention_dq"):
        assert launched[name] == cfg.num_layers * steps, (name, launched)
    # one per Lloyd iteration, the final assignment, and the validation
    assert launched["router_assign"] == KMEANS_ITERS + 2, launched
    assert launched["flash_attention"] > 0, launched
    out["device_busy_share"] = train_busy_share(tr)
    return out, ds, base


def train_rerouted(tr, cfg, base, cents, val, routed) -> dict:
    """Frequent-token routing (paper §2.4.3) over the trained paths: the
    validation documents re-routed every REROUTE_TRAIN tokens by the
    k-means router (features of the previous chunk under the base
    model), beside the route-once evaluation.  router_assign must launch
    once a chunk."""
    chunks = len(range(cfg.route_prefix_len, DOC_LEN, REROUTE_TRAIN))
    reset_counts()
    t0 = time.perf_counter()
    out = evaluate_rerouted([tr.path_params(p) for p in range(TRAIN_PATHS)],
                            cfg, KMeansRouter(cents), base, val,
                            every=REROUTE_TRAIN)
    torch.cuda.synchronize()
    launched = counts()
    out.update(every=REROUTE_TRAIN, chunks=chunks,
               seconds=time.perf_counter() - t0, launches=launched)
    print(f"[train reroute] route-once nll {routed['nll']:.4f}, re-routed "
          f"every {REROUTE_TRAIN} tokens nll {out['nll']:.4f} (switch rate "
          f"{out['switch_rate']:.3f}), launches {launched}", flush=True)
    assert np.isfinite(out["nll"]), out
    assert launched["router_assign"] == chunks, (launched, chunks)
    assert launched["flash_attention"] > 0, launched
    return out


def remat_cost(cfg) -> dict:
    """One worker's inner step (loss, gradient, in-place AdamW) at the training
    shape (TRAIN_BATCH x DOC_LEN), with remat as configured and without:
    the host-clock median of 7 steps after two warm-up steps, the device
    time of one more (profiled), and the peak device memory over the
    timed steps (and above what was resident before them: weights, AdamW
    state, batch).  The peak with remat must be the lower."""
    params = api.init_model(cfg, seed=3, device="cuda")
    opt = adamw_init(params)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DOC_LEN, seed=6)
    batch = {"tokens": torch.as_tensor(corpus.sample_documents(TRAIN_BATCH),
                                       device="cuda")}
    lr = torch.tensor(1e-3, device="cuda")
    out = {}
    for remat in (cfg.remat, not cfg.remat):
        c = cfg.replace(remat=remat)

        def step():
            _, _, grads = value_and_grad(params, c, batch)
            adamw_update_(grads, opt, params, lr=lr)    # the trainers' step

        for _ in range(2):
            step()
        free_memory()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        # the device's work in one step (kernel time summed from a
        # profile), steadier than the host clock, which spreads up to 2x
        # between calls
        prof = profiled(step, 4)
        out["remat" if remat else "no_remat"] = {
            "step_ms": float(np.median(seconds)) * 1e3,
            "step_ms_all": [x * 1e3 for x in seconds],
            "device_ms": prof["device_ms"], "busy_share": prof["busy_share"],
            "peak_memory_gib": peak / 2 ** 30,
            "peak_above_resident_gib": (peak - resident) / 2 ** 30}
    out["remat_policy"] = cfg.remat_policy
    print(f"[train remat] one worker's inner step, B{TRAIN_BATCH} "
          f"S{DOC_LEN}: {out}")
    assert out["remat"]["peak_memory_gib"] < \
        out["no_remat"]["peak_memory_gib"], out
    del params, opt
    free_memory()
    return out


def train_busy_share(tr) -> dict:
    """Device kernel time over wall time for one inner step of all
    workers (after the counted run), read both from the raw trace and from
    ``key_averages``, with the three attention kernels' share."""
    batches = torch.as_tensor(np.stack(
        [ld.tokens[:TRAIN_BATCH] for ld in tr.loaders]), device="cuda")
    out = profiled(lambda: tr._step_fn(
        tr.worker_params, tr.opt_state, {"tokens": batches},
        tr.lr(tr.step).cuda()), 8, key_averages=True,
        tracked=("flash_fwd_wgmma", "dkv_wgmma", "dq_wgmma"))
    print(f"[train profile] {out}")
    return out


def train_grad_parity(cfg, dtype: str) -> dict:
    """One inner step's loss gradient on fixed weights, through the
    kernels (attn_impl="pallas") and through the plain attention
    (attn_impl="full"): ||a - b|| / ||b|| for every leaf."""
    cfg_k = cfg.replace(dtype=dtype)
    params = api.init_model(cfg_k, seed=11, device="cuda")
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DOC_LEN, seed=5)
    batch = {"tokens": torch.as_tensor(corpus.sample_documents(2),
                                       device="cuda")}
    grads = {}
    for impl in ("pallas", "full"):
        loss, _, g = value_and_grad(params, cfg_k.replace(attn_impl=impl),
                                    batch)
        grads[impl] = (float(loss), tree_leaves(g))
    errs = [float((a.float() - b.float()).norm() / b.float().norm()
                  .clamp_min(1e-30))
            for a, b in zip(grads["pallas"][1], grads["full"][1])]
    out = {"loss_kernels": grads["pallas"][0], "loss_plain": grads["full"][0],
           "leaves": len(errs), "max_rel_err": max(errs),
           "tol": TRAIN_GRAD_TOL[dtype]}
    print(f"[train grads] {dtype}: {out}")
    assert all(float(b.float().norm()) > 0 for b in grads["pallas"][1])
    assert max(errs) <= TRAIN_GRAD_TOL[dtype], out
    return out


# ---------------------------------------------------------------------------
# Phase 6: training the SSM and token-MoE families
# ---------------------------------------------------------------------------
# (name, DiPaCo config, batch a worker, blocks or None for full depth):
# mamba2-1.3b as a 2-path flat DiPaCo at 24 of its 48 blocks (all 48 fit:
# the trainer keeps two workers' bf16 weights and f32 AdamW moments, two
# paths' f32 weights and their outer momentum, about 45 GiB, and its
# inner and outer steps update them in place, in slabs of 2^24 elements;
# cut to end the default run within 1000 s on a slow host, PERF.md
# section 4); qwen2-moe-a2.7b cut to 2 of 24 blocks (full depth needs
# about 170 GB for its weights and AdamW moments alone), one worker
FAMILY_TRAIN = (("mamba2-1.3b", flat_moe_config(2, inner_steps=2), 4, 24),
                ("qwen2-moe-a2.7b", diloco_config(1, inner_steps=2), 4, 2))
FAMILY_TAU, FAMILY_PHASES, FAMILY_GRAD_DEPTH = 2, 2, 4
# mamba2-1.3b's peak allocated memory at 24 blocks under the functional
# inner step on the H100 (PERF.md section 5)
def dryrun_phase(cfg, remat: dict) -> dict:
    """The dry-run of ``cfg`` (``dryrun.run_case``) at the four input
    shapes on the 16x16 logical mesh, on meta tensors (nothing on the
    card; the outer step's gathers at train_4k), its records printed;
    then phase 4's worker step (``remat_cost``: B8 S1024, remat, the
    host-clock median between syncs) beside two shares of the H100's
    bf16 peak, by the analytic ``total_flops`` of that step and by
    ``model_flops`` (6 N D), and the predicted bytes of one worker's
    parameters and AdamW state (from the meta shape trees) beside the
    step's measured resident and peak memory (the train_4k record's bytes
    a rank: one worker's tree whole)."""
    records = [dryrun.run_case(cfg.name, name, multi_pod=False,
                               with_outer=name == "train_4k")
               for name in INPUT_SHAPES]
    print(json.dumps({"dryrun_records": records}), flush=True)
    for rec in records:
        assert rec["ok"], rec.get("traceback")
    shape = InputShape("phase4_step", DOC_LEN, TRAIN_BATCH, "train")
    step = remat["remat"]
    step_s = step["step_ms"] / 1e3
    total = flopmodel.analyze(cfg, shape, num_workers=1).total_flops
    model = specs.model_flops(cfg, shape)
    rank = records[0]["memory"]["per_rank"]
    predicted = (rank["params"] + rank["optimizer"]) / 2 ** 30
    resident = step["peak_memory_gib"] - step["peak_above_resident_gib"]
    out = {"records": [{k: r[k] for k in ("shape", "counted_flops",
                                          "total_flops", "roofline",
                                          "useful_flops_ratio")}
                       for r in records],
           "step_ms": step["step_ms"], "analytic_step_flops": total,
           "model_step_flops": model,
           "peak_share_analytic": total / step_s / PEAK_FLOPS_BF16,
           "peak_share_model_flops": model / step_s / PEAK_FLOPS_BF16,
           "predicted_params_adamw_gib": predicted,
           "measured_resident_gib": resident,
           "measured_peak_gib": step["peak_memory_gib"]}
    print(f"[dryrun] phase 4's worker step {step['step_ms']:.2f} ms "
          f"(B{TRAIN_BATCH} S{DOC_LEN}, remat): "
          f"{out['peak_share_analytic']:.4f} of the bf16 peak by the "
          f"analytic count ({total:.4g} FLOP), "
          f"{out['peak_share_model_flops']:.4f} by 6 N D ({model:.4g})",
          flush=True)
    print(f"[dryrun memory] one worker's parameters + AdamW state "
          f"predicted {predicted:.3f} GiB; the step measured "
          f"{resident:.3f} GiB resident, {step['peak_memory_gib']:.3f} "
          f"GiB peak", flush=True)
    assert 0 < out["peak_share_analytic"] < 1, out
    return out


MAMBA_24_BLOCK_PEAK_GIB = 60.39


def train_family(name: str, dcfg, batch: int, depth,
                 dev: str = "cuda", peak_lr: float = 2e-3) -> dict:
    """make_trainer(backend="vector") at full width (bf16, pallas, remat
    "full"), 2 phases of 2 inner steps on synthetic 1024-token documents
    sharded by domain; the loss must fall and, on the card, every kernel
    of the path launch as its blocks and steps need."""
    cfg = get_config(name).replace(attn_impl="pallas", dtype="bfloat16",
                                   remat=True)
    if depth is not None:
        cfg = cfg.replace(num_layers=depth)
    assert cfg.remat_policy == "full", cfg
    t_start = time.perf_counter()
    paths = int(np.prod(dcfg.levels))
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DOC_LEN, seed=0)
    docs, domains = corpus.sample_documents(16 * paths, seed=1,
                                            return_domains=True)
    ds = shard_documents(docs, domains % paths, paths)
    free_memory()
    reset_peak(dev)
    base = api.init_model(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(base))
    tr = make_trainer(cfg, dcfg, ds, backend="vector", device=dev,
                      base_params=base, batch_size=batch, peak_lr=peak_lr,
                      warmup=1, total_steps=FAMILY_PHASES * FAMILY_TAU)
    del base
    timer = tr._step_fn = TimedStep(tr._step_fn, dev)
    reset_counts()
    phases = []
    try:
        for _ in range(FAMILY_PHASES):
            m = tr.run_phase()
            phases.append({"mean_loss": m.mean_loss,
                           "final_loss": m.final_loss})
    except torch.cuda.OutOfMemoryError:
        # what holds the memory: the trainer's trees, then the allocator
        held = {k: sum(t.numel() * t.element_size()
                       for t in tree_leaves(getattr(tr, k))) / 2 ** 30
                for k in ("worker_params", "global_params", "opt_state",
                          "outer_state")}
        print(f"[train {name}] out of memory at {cfg.num_layers} blocks: "
              f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
              f"GiB, trainer state GiB {held}", flush=True)
        print(torch.cuda.memory_summary(abbreviated=True), flush=True)
        raise
    sync(dev)
    launched = counts()
    W = tr.num_workers
    steps = W * FAMILY_TAU * FAMILY_PHASES
    blocks = list(cfg.pattern) * cfg.pattern_repeats
    attn = sum(b.mixer == "attn" for b in blocks)
    mamba = sum(b.mixer == "mamba" for b in blocks)
    moe = sum(b.mlp == "moe" for b in blocks)
    gemms = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    # remat: each block's forward runs twice a step (forward, recompute)
    want = {"ssd_scan": 2 * mamba * steps, "ssd_scan_bwd": mamba * steps,
            "expert_gemm": 2 * gemms * moe * steps,
            "expert_gemm_dx": gemms * moe * steps,
            "expert_gemm_dw": gemms * moe * steps,
            "flash_attention_lse": 2 * attn * steps,
            "flash_attention_dkv": attn * steps * dkv_launches(
                torch.bfloat16, cfg.head_dim),
            "flash_attention_dq": attn * steps}
    out = {"blocks": cfg.num_layers, "workers": W, "paths": paths,
           "batch": batch, "params_per_path": n_params, "phases": phases,
           "inner_step_s_per_worker": float(np.median(timer.seconds)) / W,
           "inner_step_s_all": timer.seconds,
           "tokens_per_s": batch * DOC_LEN * W / float(np.median(
               timer.seconds)),
           "peak_memory_gib": peak_gib(dev),
           "launches": launched, "expected_launches": want,
           "seconds": time.perf_counter() - t_start}
    print(f"[train {name}] {out}")
    if name == "mamba2-1.3b":
        print(f"[train {name}] peak allocated {out['peak_memory_gib']:.2f} "
              f"GiB at {cfg.num_layers} blocks (24 blocks under the "
              f"functional step: {MAMBA_24_BLOCK_PEAK_GIB} GiB)", flush=True)
    losses = [ph["mean_loss"] for ph in phases]
    assert all(np.isfinite(losses)) and losses[1] < losses[0], out
    if dev == "cuda":
        assert {k: launched[k] for k in want} == want, (launched, want)
    del tr
    free_memory()
    return out


def leaf_names(tree, prefix: str = "") -> list:
    """The "/"-joined key path of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def slab_sums(a, b, slab: int = 1 << 26) -> tuple:
    """(||a - b||^2, ||a||^2, ||b||^2) in f32 on b's device, over slabs of
    ``slab`` elements of the flattened leaves (``a`` may lie on the host),
    so that no f32 copy of a leaf of several GB is made whole: one of
    nemotron-4-340b's 256000 x 18432 tables is 17.6 GiB in f32, its
    block's stacked (1, 18432, 73728) MLP leaves 5.1 GiB each."""
    a, b = a.reshape(-1), b.reshape(-1)
    sums = [0.0, 0.0, 0.0]
    for i in range(0, b.numel(), slab):
        x = a[i:i + slab].to(b.device).float()
        y = b[i:i + slab].float()
        for j, t in enumerate((x - y, x, y)):
            sums[j] += float(t.square().sum())
    return tuple(sums)


def family_grad_parity(name: str, dtype: str, depth: int = FAMILY_GRAD_DEPTH,
                       extras=None, dev: str = "cuda") -> dict:
    """One inner step's loss gradient at full width, ``depth`` blocks
    deep (an encoder-decoder: as deep again in its encoder), through the
    kernels and through the plain path, leaf by leaf; the MoE router
    teacher-forced (a near-tie would flip a token's experts).
    ``extras(cfg, gen)`` adds entries to the batch (frames, patch
    embeddings).  Weights above 16 GiB keep the kernels' gradients on
    the host while the plain run computes its own (three device copies
    of jamba's 24 GiB would not fit)."""
    cfg = cut_layers(get_config(name).replace(dtype=dtype), depth)
    params = api.init_model(cfg, seed=11, device=dev)
    offload = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params)) > 16 * 2 ** 30
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DOC_LEN, seed=5)
    batch = {"tokens": torch.as_tensor(corpus.sample_documents(2),
                                       device=dev)}
    if extras is not None:
        batch.update(extras(cfg, torch.Generator(device=dev).manual_seed(5)))
    grads = {}
    with ForcedExperts() as choices:
        for impl, run in (("pallas", "kernels"), ("full", "plain")):
            choices.run = run
            reset_counts()
            loss, _, g = value_and_grad(
                params, cfg.replace(attn_impl=impl), batch)
            if impl == "pallas":
                launched = counts()
            leaves = tree_leaves(g)
            del g
            if offload and impl == "pallas":
                leaves = [x.cpu() for x in leaves]
            grads[impl] = (float(loss), leaves)
    sums = [slab_sums(a, b)
            for a, b in zip(grads["pallas"][1], grads["full"][1])]
    errs = [(d2 / max(b2, 1e-60)) ** 0.5 for d2, _, b2 in sums]
    names = leaf_names(params)
    worst = sorted(range(len(errs)), key=lambda i: -errs[i])[:3]
    out = {"blocks": cfg.num_layers, "loss_kernels": grads["pallas"][0],
           "loss_plain": grads["full"][0], "leaves": len(errs),
           "max_rel_err": max(errs), "tol": TRAIN_GRAD_TOL[dtype],
           "worst_leaves": {names[i]: errs[i] for i in worst},
           "offloaded": offload, "launches": launched}
    print(f"[train grads {name}] {dtype}: {out}")
    assert all(a2 > 0 for _, a2, _ in sums)
    assert max(errs) <= TRAIN_GRAD_TOL[dtype], out
    del params, grads
    free_memory()
    return out


# ---------------------------------------------------------------------------
# Phase 7: the continuous-batching engine at full width
# ---------------------------------------------------------------------------
# dipaco-150m, 4 paths of 8 slots over a 512-token ring; a Poisson trace of
# 64 requests at 200 a second (prompts of 32, 64 or 128 tokens, 32 new;
# 30% interactive, 70% preemptible), routed by a prompt hash
CB_PATHS, CB_SLOTS, CB_CACHE, CB_REROUTE = 4, 8, 512, 8
CB_TRACE = dict(n=64, rate=200.0, prompt_lens=(32, 64, 128), max_new=32,
                seed=0, priorities=((PRIO_HIGH, PRIO_PREEMPTIBLE), (0.3, 0.7)))
# the simulated clock of the token-identity runs: 10 ms a tick, so that
# arrivals meet full islands (backpressure, preemption) as in realtime,
# while both runs see the same admissions and ticks
CB_SIM_DT = 0.01
CB_PROFILED_REPLAYS = 5
# the masked SSM state on the card: mamba2-1.3b cut to 4 of its 48 blocks
# (time), widths unchanged, f32; 2 paths of 4 slots, 16 requests
CB_MAMBA_DEPTH, CB_MAMBA_SLOTS, CB_MAMBA_REQUESTS = 4, 4, 16
PHASE7_DIR = Path(__file__).resolve().parent / "build" / "phase7"


def cb_engine(cfg, paths, *, graph: bool, tel=None, router=None,
              reroute_every: int = 0, slots: int = CB_SLOTS,
              cache_len: int = CB_CACHE, stacked=None):
    eng = ContinuousBatchingEngine(cfg, paths, options=EngineOptions(
        cache_len=cache_len, slots_per_path=slots, cuda_graph=graph,
        telemetry=tel, router=router, stacked=stacked,
        feat_params=paths[0] if router is not None else None,
        route_fn=None if router is not None
        else prefix_hash_router(len(paths)),
        reroute_every=reroute_every))
    eng.warmup()
    return eng


def percentiles(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def cb_run(cfg, paths, name: str, card: str, *, graph: bool,
           realtime: bool = True, router=None,
           reroute_every: int = 0) -> dict:
    """One run of the trace through a fresh, warmed-up engine (its dense
    tick captured where ``graph``), the kernels' counts set to 0 just
    before it and read just after.  Checks that every request finishes
    with in-range tokens, every slot comes back, the run exerts
    backpressure, and flash-decode
    launched once an attention block for every decode the host
    dispatched (the eager dense ticks, the sparse ticks' islands),
    flash attention once a block for every feature call.  The ticks'
    host times come from the engine's ``serve.tick`` spans (telemetry
    on); then the same trace runs again under torch.profiler for the
    device busy share."""
    trace = poisson_trace(vocab_size=cfg.vocab_size, **CB_TRACE)
    PHASE7_DIR.mkdir(parents=True, exist_ok=True)
    tel_path = PHASE7_DIR / f"{name}.jsonl"
    tel = Telemetry(tel_path, fresh=True, meta={"run": name})
    eng = cb_engine(cfg, paths, graph=graph, tel=tel, router=router,
                    reroute_every=reroute_every)
    assert (eng._graph is not None) == graph
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fins = eng.serve_trace(trace, realtime=realtime, tick_dt=CB_SIM_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    tel.close()
    ticks_ms = [(r["t1"] - r["t0"]) / 1e6 for r in read_trace(tel_path)[0]
                if r.get("name") == "serve.tick"]
    stats = dict(eng.decode_stats)
    sched = dataclasses.asdict(eng.scheduler.stats)
    n = CB_TRACE["n"]
    new_tokens = n * CB_TRACE["max_new"]
    assert sorted(f.rid for f in fins) == list(range(n)), name
    assert not eng.in_flight and all(a.num_free == CB_SLOTS
                                     for a in eng.arenas), name
    for f in fins:
        gen = f.tokens[len(trace[f.rid].prompt):]
        assert len(gen) == CB_TRACE["max_new"], (name, f.rid)
        assert ((gen >= 0) & (gen < cfg.vocab_size)).all(), (name, f.rid)
    attn = sum(b.mixer == "attn" for b in cfg.pattern) * cfg.pattern_repeats
    host_decodes = (stats["dense"] - stats["graph_replays"]
                    + stats["sparse_islands"] + stats["looped_islands"])
    assert launched["flash_decode"] == attn * host_decodes, (name, launched,
                                                             stats)
    assert launched["flash_attention"] == attn * stats["feature_calls"], (
        name, launched, stats)
    assert (stats["graph_replays"] == stats["dense"] > 0) if graph else \
        stats["graph_replays"] == 0, (name, stats)
    # the trace overloads the islands: queued requests wait on slots
    # (how many high-priority arrivals find a full island of preemptible
    # requests depends on the host's tick time in realtime, so the
    # preemptions are checked on the simulated clock, in `continuous`)
    assert sched["backpressure_ticks"] > 0, (name, sched)
    out = {"card": card, "cuda_graph": graph, "realtime": realtime,
           "tokens_per_s": new_tokens / wall, "seconds": wall,
           "ticks": eng.ticks, "decode": stats, "scheduler": sched,
           "switches": sum(f.switches for f in fins),
           "latency_ms": {k: v * 1e3 for k, v in percentiles(
               [f.latency for f in fins]).items()},
           "ttft_ms": {k: v * 1e3 for k, v in percentiles(
               [f.ttft for f in fins]).items()},
           "tick_ms": {"median": float(np.median(ticks_ms)),
                       "spans": len(ticks_ms)},
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launched,
           "tokens": {f.rid: f.tokens.tolist() for f in fins}}
    assert len(ticks_ms) == eng.ticks, (name, len(ticks_ms), eng.ticks)
    if realtime:
        prof = profiled(lambda: eng.serve_trace(trace, realtime=True), 6,
                        tracked=("decode_kernel",))
        out["device_busy_share"] = prof["busy_share"]
        out["profile"] = prof
    if graph:
        out["graph"] = graph_tick_profile(eng, attn)
    summary = {k: v for k, v in out.items() if k not in ("tokens",
                                                         "profile")}
    print(f"[continuous {name}] {card}: {summary}", flush=True)
    del eng
    free_memory()
    return out


def graph_tick_profile(eng, attn: int) -> dict:
    """The captured dense tick on its own, with the mask all False (the
    replays leave every cache row as it was): torch.profiler over a few
    replays must show one flash-decode kernel an attention block and
    replay (the Python counter does not see replays); CUDA events time a
    replay against the same tick run eagerly from Python."""
    g = eng._graph
    g.inp.zero_()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(CB_PROFILED_REPLAYS):
            g.graph.replay()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    decodes = sum("decode_kernel" in n for n in names)
    assert decodes == attn * CB_PROFILED_REPLAYS, (decodes, attn)
    with torch.no_grad():
        eager_ms = time_ms(lambda: eng._dense_body(g.inp), iters=20)
    return {"decode_kernels_per_replay": decodes / CB_PROFILED_REPLAYS,
            "kernels_per_replay": len(names) / CB_PROFILED_REPLAYS,
            "replay_ms": time_ms(g.graph.replay), "eager_tick_ms": eager_ms}


def continuous(card: str) -> dict:
    """Phase 7: dipaco-150m at full width through the continuous engine:
    the trace in realtime eager and with the CUDA-graph tick, the same
    two on the simulated clock (greedy tokens must be equal; both must
    preempt and exert backpressure), a realtime run routed by a
    discriminative router with re-routing every 8 tokens, then the
    mamba2-1.3b stacked tick against the looped one."""
    cfg = get_config("dipaco-150m").replace(attn_impl="pallas",
                                            dtype="bfloat16")
    paths = [api.init_model(cfg, seed=p, device="cuda")
             for p in range(CB_PATHS)]
    runs = {"eager": cb_run(cfg, paths, "eager", card, graph=False),
            "graph": cb_run(cfg, paths, "graph", card, graph=True)}
    sim = {k: cb_run(cfg, paths, f"sim_{k}", card, graph=k == "graph",
                     realtime=False) for k in ("eager", "graph")}
    assert sim["graph"]["tokens"] == sim["eager"]["tokens"], \
        "graph tick tokens differ from the eager tick's"
    assert sim["graph"]["scheduler"] == sim["eager"]["scheduler"]
    assert sim["eager"]["scheduler"]["preemptions"] > 0, sim["eager"]
    runs["realtime_tokens_equal"] = sum(
        runs["graph"]["tokens"][rid] == toks
        for rid, toks in runs["eager"]["tokens"].items())
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=PROMPT_LEN, seed=0)
    feats = prefix_features(paths[0], cfg, corpus.sample_documents(64,
                                                                   seed=1))
    gen = torch.Generator(device="cuda").manual_seed(4321)
    router = DiscriminativeRouter(
        w=torch.randn((cfg.d_model, CB_PATHS), generator=gen, device="cuda"),
        b=torch.zeros(CB_PATHS, device="cuda"), mu=feats.mean(0),
        sigma=torch.clamp_min(feats.std(0), 1e-6))
    runs["router"] = cb_run(cfg, paths, "router", card, graph=True,
                            router=router, reroute_every=CB_REROUTE)
    assert runs["router"]["decode"]["feature_calls"] > CB_TRACE["n"]
    for r in (*runs.values(), *sim.values()):
        if isinstance(r, dict):
            r.pop("tokens", None)
    runs["sim"] = sim
    del paths, feats, router
    free_memory()
    runs["mamba"] = continuous_mamba(card)
    return runs


def continuous_mamba(card: str) -> dict:
    """mamba2-1.3b (4 of 48 blocks, f32, 2 paths of 4 slots): the stacked
    tick (decode_step_paths, masked SSM state) against the looped one
    (one masked decode_step an island), same trace on the simulated
    clock: equal greedy tokens; prefill (batch 1, no buckets) launches
    ssd_scan once a block and request."""
    cfg = get_config("mamba2-1.3b").replace(
        attn_impl="pallas", dtype="float32", num_layers=CB_MAMBA_DEPTH)
    paths = [api.init_model(cfg, seed=p, device="cuda") for p in range(2)]
    trace = poisson_trace(CB_MAMBA_REQUESTS, rate=200.0,
                          prompt_lens=(32, 64), max_new=16,
                          vocab_size=cfg.vocab_size, seed=1)
    out, tokens = {"card": card, "blocks": CB_MAMBA_DEPTH}, {}
    for stacked in (True, False):
        eng = cb_engine(cfg, paths, graph=False, slots=CB_MAMBA_SLOTS,
                        cache_len=128, stacked=stacked)
        assert not eng.bucketed and eng.stacked is stacked
        reset_counts()
        t0 = time.perf_counter()
        fins = eng.serve_trace(trace, tick_dt=CB_SIM_DT)
        torch.cuda.synchronize()
        key = "stacked" if stacked else "looped"
        launched = counts()
        assert launched["ssd_scan"] == CB_MAMBA_DEPTH * len(trace), launched
        assert all(a.num_free == CB_MAMBA_SLOTS for a in eng.arenas)
        tokens[key] = {f.rid: f.tokens.tolist() for f in fins}
        out[key] = {"seconds": time.perf_counter() - t0,
                    "ticks": eng.ticks, "decode": dict(eng.decode_stats),
                    "launches": launched}
        del eng
    assert sorted(tokens["stacked"]) == list(range(len(trace)))
    assert tokens["stacked"] == tokens["looped"], \
        "mamba2 stacked tick tokens differ from the looped tick's"
    print(f"[continuous mamba2-1.3b] {card}: {out}", flush=True)
    del paths
    free_memory()
    return out


# ---------------------------------------------------------------------------
# Phase 8: the §3 training service at full width
# ---------------------------------------------------------------------------
# phase 4's dipaco-150m (bf16, pallas, remat) at full width, its sharded
# data and its base weights cut to SVC_DEPTH blocks; a 2x2 DiPaCo, batch
# 8 a worker, tau 4.  (a) the barrier trainer on 4 pool threads against
# the vector trainer, 2 phases, and two barrier runs with a planted fault
# that the bound must catch; (b) the pipelined service: staleness window
# 1, 4 fragments, int8 wire, preemptions, 3 phases; (c) kill and resume
# on one thread at lag 0 (the reference's bit-exact setting)
SVC_THREADS, SVC_PHASES, SVC_LAG, SVC_FRAGMENTS = 4, 3, 1, 4
SVC_PREEMPT = 0.2
# the pool draws its preemptions from random.Random(seed); seed 1's first
# draw is 0.13, so the service run preempts at least once at p = 0.2
SVC_SEED = 1
# (b)'s outer step: Nesterov without momentum (outer lr 0.7).  With tau 4
# (the paper's is 150) consecutive phases' deltas point nearly the same
# way, and the default momentum 0.9 carries them past the minimum by the
# third phase: the vector trainer's loss rises there too.  At lag 1 a
# shard's next delta is taken from a snapshot that misses the others'
# last deltas, so the same step is counted twice and the rise grows; the
# JAX service does the same (tests/test_torch_service_stale.py).  On one
# pool thread (H100, `--service-probe`), 12 blocks: 9.946, 8.516, 9.585
# at momentum 0.9 and 9.946, 8.510, 7.847 without; 2 blocks: 9.764,
# 7.937, 8.036 and 9.764, 7.989, 6.967
SVC_OUTER_MOMENTUM = 0.0
# Every row moves a whole tree (the workers' snapshots, deltas and AdamW
# moments, the modules' params and momenta), and the DB lives in the
# run's own temporary directory (tempfile), on the machine's disk, which
# takes 45 GiB of writes a run, deleted files included.  At 12 blocks the
# phase wrote about 110 GB (8.8 GB a barrier phase, 13.0 a service phase,
# 9.6 a phase of the kill and resume runs; NVIDIA H100, PERF.md section
# 5), so it runs the first 2 of the 12 blocks: 49M of the 150M
# parameters (28.7M of them the tied embedding), about a third of the
# bytes, and fails if its rows pass SVC_BUDGET_GB
SVC_DEPTH = 2
SVC_BUDGET_GB = 40.0
# barrier vs vector in bf16.  The executors add the contributions in
# commit order (the vector trainer's einsum in its own) and keep the
# module store in bf16, where the vector trainer keeps f32 global copies
# and rounds only the workers' copies: an outer step can land one bf16
# rounding apart, and the next phase's deltas differ by the global
# copy's rounding (half a bf16 step of each element).  Where such a
# difference flips the sign of a near-zero gradient, AdamW moves the
# element by up to 2 lr a step the other way (up to 0.012 over a phase
# of this schedule, 0.016 after the outer step).  So, per leaf: the
# largest |a - b| within 2^-5 of the largest |b| (8 bf16 steps; 0.0189
# measured on the H100 at 2 blocks after 2 phases), and the mean |a - b|
# within 2^-7 of the mean |b| (two bf16 roundings; 0.0020 measured).  A
# wrong weight or a missed contribution moves elements by a share of a
# phase's delta: the planted faults below must break one of the two
# after one phase (their means measured 0.053 and 0.140, the sound
# run's 1.7e-8).  Per-phase mean losses within 1e-2 (about 10 here)
SVC_MAX_REL, SVC_MEAN_REL, SVC_LOSS_TOL = 2 ** -5, 2 ** -7, 1e-2
# the planted faults, in every executor that worker 0 reports to:
# "weight" halves its weight, "dropped" folds zeros for its delta (a
# contribution that counts but was lost)
SVC_FAULTS = ("weight", "dropped")


def svc_kwargs(base, **over) -> dict:
    kw = dict(base_params=base, batch_size=TRAIN_BATCH, peak_lr=2e-3,
              warmup=TAU, total_steps=SVC_PHASES * TAU, device="cuda",
              phase_timeout=600.0)
    kw.update(over)
    return kw


def cut_depth(cfg, base, depth: int) -> tuple:
    """``cfg`` and its weights cut to their first ``depth`` blocks."""
    if depth == cfg.num_layers:
        return cfg, base
    cut = pytree.tree_map(
        lambda leaf, ax: (leaf[:depth].clone() if ax and ax[0] == LAYERS
                          else leaf), base, param_axes(cfg),
        is_leaf=lambda x: isinstance(x, tuple))
    return cfg.replace(num_layers=depth), cut


def training_launches(cfg, steps: int) -> dict:
    """The attention kernels' launches for ``steps`` worker steps (remat
    runs the LSE forward twice a block and step)."""
    forwards = 2 if cfg.remat else 1
    return {"flash_attention_lse": forwards * cfg.num_layers * steps,
            "flash_attention_dkv": cfg.num_layers * steps,
            "flash_attention_dq": cfg.num_layers * steps}


def check_launches(cfg, launched: dict, steps: int, what: str) -> None:
    want = training_launches(cfg, steps)
    got = {k: launched[k] for k in want}
    assert got == want, (what, got, want)


def path_leaves(tr, p: int) -> list:
    return [x.detach().clone() for x in pytree.leaves(tr.path_params(p))]


def param_rel(tr, ref_params) -> tuple:
    """Over every path's leaves: the largest max|a - b| / max|b| and the
    largest mean|a - b| / mean|b|."""
    max_rel, mean_rel = [], []
    for p in range(TRAIN_PATHS):
        for a, b in zip(path_leaves(tr, p), ref_params[p]):
            d, b = (a.float() - b.float()).abs(), b.float().abs()
            max_rel.append(float(d.max() / b.max().clamp_min(1e-30)))
            mean_rel.append(float(d.mean() / b.mean().clamp_min(1e-30)))
    return max(max_rel), max(mean_rel)


def io_since(before: dict) -> dict:
    now = ckpt_db.io_stats()
    return {k: now[k] - before[k] for k in now}


def plant_fault(tr, fault: str) -> None:
    execs = tr.service.execs
    for ex in [*execs.execs.values(), execs.shared_exec]:
        if ex is None or 0 not in ex.alphas:
            continue
        if fault == "weight":
            ex.alphas[0] *= 0.5
            continue

        def fold(win, worker, tag, part, inner=ex._fold_locked):
            if worker == 0:
                part = {i: torch.zeros_like(x) for i, x in part.items()}
            return inner(win, worker, tag, part)

        ex._fold_locked = fold


def service_phase(cfg, ds, base, root) -> dict:
    """(a) backend="barrier" (4 threads) against backend="vector", 2
    phases from the same base weights; per-phase seconds, row writes and
    the DB's bytes.  Then each planted fault, one phase, must break the
    bound against the vector trainer's first phase."""
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=TAU)
    reset_counts()
    vec = make_trainer(cfg, dcfg, ds, backend="vector", device="cuda",
                       base_params=base, batch_size=TRAIN_BATCH, peak_lr=2e-3,
                       warmup=TAU, total_steps=SVC_PHASES * TAU)
    vec_losses, vec_params = [], []
    for _ in range(PHASES):
        vec_losses.append(vec.run_phase().mean_loss)
        vec_params.append([path_leaves(vec, p) for p in range(TRAIN_PATHS)])
    torch.cuda.synchronize()
    check_launches(cfg, counts(), ds.num_shards * TAU * PHASES, "vector")
    del vec
    free_memory()
    bar = make_trainer(cfg, dcfg, ds, backend="barrier",
                       ckpt_root=str(root / "barrier"),
                       **svc_kwargs(base, num_workers=SVC_THREADS))
    try:
        reset_counts()
        phases = []
        for ph in range(PHASES):
            io0 = ckpt_db.io_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = bar.run_phase()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            io = io_since(io0)
            max_rel, mean_rel = param_rel(bar, vec_params[ph])
            phases.append({"mean_loss": m.mean_loss, "seconds": wall,
                           "row_write_thread_s": io["d2h_s"] + io["write_s"],
                           "d2h_thread_s": io["d2h_s"],
                           "rows_written": io["rows_written"],
                           "d2h_gb": io["d2h_bytes"] / 1e9,
                           "file_gb": io["file_bytes"] / 1e9,
                           "outer_updates": m["outer_updates"],
                           "param_max_rel": max_rel,
                           "param_mean_rel": mean_rel})
        launched = counts()
        check_launches(cfg, launched, ds.num_shards * TAU * PHASES, "barrier")
        out = {"phases": phases, "vector_losses": vec_losses,
               "param_max_rel": phases[-1]["param_max_rel"],
               "param_mean_rel": phases[-1]["param_mean_rel"],
               "tol": [SVC_MAX_REL, SVC_MEAN_REL, SVC_LOSS_TOL],
               "db_gb": bar.db.nbytes() / 1e9,
               "pool_errors": bar.service.pool.errors, "launches": launched}
    finally:
        bar.shutdown()
    del bar
    shutil.rmtree(root / "barrier", ignore_errors=True)
    free_memory()
    print(f"[service barrier] {out}", flush=True)
    assert out["pool_errors"] == 0
    for ph, vl in zip(phases, vec_losses):
        assert abs(ph["mean_loss"] - vl) <= SVC_LOSS_TOL, (ph, vl)
    assert out["param_max_rel"] <= SVC_MAX_REL, out
    assert out["param_mean_rel"] <= SVC_MEAN_REL, out
    out["planted_faults"] = {}
    for fault in SVC_FAULTS:
        bad = make_trainer(cfg, dcfg, ds, backend="barrier",
                           ckpt_root=str(root / fault),
                           **svc_kwargs(base, num_workers=SVC_THREADS))
        try:
            plant_fault(bad, fault)
            loss = bad.run_phase().mean_loss
            max_rel, mean_rel = param_rel(bad, vec_params[0])
        finally:
            bad.shutdown()
        del bad
        shutil.rmtree(root / fault, ignore_errors=True)
        free_memory()
        out["planted_faults"][fault] = {"mean_loss": loss,
                                        "param_max_rel": max_rel,
                                        "param_mean_rel": mean_rel}
    print(f"[service barrier] planted faults after one phase (sound: "
          f"{phases[0]['param_max_rel']:.5f} / "
          f"{phases[0]['param_mean_rel']:.5f}): {out['planted_faults']}",
          flush=True)
    for fault, r in out["planted_faults"].items():
        assert (r["param_max_rel"] > SVC_MAX_REL
                or r["param_mean_rel"] > SVC_MEAN_REL), (fault, r)
    return out


def phase_losses(svc, shards: int) -> list:
    return [float(np.mean([svc.losses[(t, s)] for s in range(shards)]))
            for t in range(SVC_PHASES)]


def service_async(cfg, ds, base, root) -> dict:
    """(b) backend="service": staleness window 1, 4 fragments, int8 wire,
    preemptions, 4 threads, 3 phases (the third under torch.profiler, for
    the device busy share), the outer step without momentum; every path
    reaches phase 3 with finite losses that fall phase after phase, the
    pool preempts and counts no handler error."""
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=TAU,
                        outer_fragments=SVC_FRAGMENTS, fragment_stagger=1,
                        comm_dtype="int8", outer_momentum=SVC_OUTER_MOMENTUM)
    svc = make_trainer(cfg, dcfg, ds, backend="service",
                       ckpt_root=str(root / "service"),
                       **svc_kwargs(base, num_workers=SVC_THREADS,
                                    max_phase_lag=SVC_LAG,
                                    preempt_prob=SVC_PREEMPT, seed=SVC_SEED))
    try:
        reset_counts()
        io0 = ckpt_db.io_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.run(SVC_PHASES - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        io = io_since(io0)
        # the last phase under torch.profiler: the device busy share
        prof = profiled(lambda: svc.run(1), 8, tracked=(
            "flash_fwd_wgmma", "dkv_wgmma", "dq_wgmma"))
        print(f"[service profile] one phase, {SVC_THREADS} threads: {prof}",
              flush=True)
        m = svc.run(0)
        launched = counts()
        losses = phase_losses(svc, ds.num_shards)
        out = {"seconds_first_phases": wall, "phase_losses": losses,
               "clocks": dict(svc.clock), "preemptions": svc.pool.preemptions,
               "monitor_restarts": svc.monitor.restarts,
               "pool_errors": svc.pool.errors,
               "max_observed_lag": m["max_observed_lag"],
               "outer_updates": m["outer_updates"],
               "comm": svc.comm_stats(),
               "row_write_thread_s": io["d2h_s"] + io["write_s"],
               "rows_written": io["rows_written"],
               "d2h_gb": io["d2h_bytes"] / 1e9,
               "db_gb": svc.db.nbytes() / 1e9,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": launched, "profiled_phase": prof}
        print(f"[service async] {out}", flush=True)
        assert svc.pool.errors == 0, svc.pool.last_error
        assert all(svc.clock[s] == SVC_PHASES for s in range(ds.num_shards))
        assert all(np.isfinite(losses)), losses
        assert all(b < a for a, b in zip(losses, losses[1:])), losses
        assert svc.pool.preemptions >= 1, out
        check_launches(cfg, launched, ds.num_shards * TAU * SVC_PHASES,
                       "service")
        return out
    finally:
        svc.shutdown()


def clone_db(src: Path, dst: Path) -> None:
    """The DB as it stands, under another root, without writing its rows
    again: each row's file hard-linked, ``rows.jsonl`` rewritten to name
    the links.  It is what a process killed at this point leaves."""
    dst.mkdir()
    lines = []
    for line in (src / "rows.jsonl").read_text().splitlines():
        row = json.loads(line)
        name = Path(row["file"]).name
        os.link(row["file"], dst / name)
        row["file"] = str(dst / name)
        lines.append(json.dumps(row))
    (dst / "rows.jsonl").write_text("".join(x + "\n" for x in lines))


def service_resume(cfg, ds, base, root) -> dict:
    """(c) one thread, lag 0: 3 phases uninterrupted; the DB as it stood
    after phase 2 (a hard-linked clone: its rows are written once) taken
    up by a new service through ``resume``, which runs 1 phase.  The
    path parameters and the per-phase losses must be equal bit for
    bit."""
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=TAU)
    kw = svc_kwargs(base, num_workers=1, max_phase_lag=0)
    out = {}
    ref = make_trainer(cfg, dcfg, ds, backend="service",
                       ckpt_root=str(root / "ref"), **kw)
    try:
        t0 = time.perf_counter()
        ref.run(SVC_PHASES - 1)
        clone_db(root / "ref", root / "killed")
        ref.run(1)
        out["uninterrupted_s"] = time.perf_counter() - t0
        ref_params = [path_leaves(ref, p) for p in range(TRAIN_PATHS)]
        ref_losses = dict(ref.losses)
    finally:
        ref.shutdown()
    del ref
    free_memory()
    t0 = time.perf_counter()
    res = make_trainer(cfg, dcfg, ds, backend="service",
                       ckpt_root=str(root / "killed"), resume=True, **kw)
    try:
        out["resume_s"] = time.perf_counter() - t0
        assert all(res.clock[s] == SVC_PHASES - 1
                   for s in range(ds.num_shards)), res.clock
        res.run(1)
        same = [bool(torch.equal(a, b)) for p in range(TRAIN_PATHS)
                for a, b in zip(path_leaves(res, p), ref_params[p])]
        out.update(leaves_equal=sum(same), leaves=len(same),
                   losses_equal=res.losses == ref_losses,
                   pool_errors=res.pool.errors,
                   cublas_workspace_config=os.environ.get(
                       "CUBLAS_WORKSPACE_CONFIG"))
        print(f"[service resume] {out}", flush=True)
        assert res.pool.errors == 0, res.pool.last_error
        assert all(same), out
        assert res.losses == ref_losses, (res.losses, ref_losses)
        return out
    finally:
        res.shutdown()


def service(cfg, ds, base) -> dict:
    cfg, base = cut_depth(cfg, base, SVC_DEPTH)
    root = Path(tempfile.mkdtemp(prefix="dipaco-phase8-"))
    io0 = ckpt_db.io_stats()
    try:
        out = {"depth": SVC_DEPTH, "ckpt_root": str(root),
               "barrier": service_phase(cfg, ds, base, root)}
        out["service"] = service_async(cfg, ds, base, root)
        shutil.rmtree(root / "service", ignore_errors=True)
        free_memory()
        out["resume"] = service_resume(cfg, ds, base, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_memory()
    out["file_gb"] = io_since(io0)["file_bytes"] / 1e9
    print(f"[service] {SVC_DEPTH} of 12 blocks: {out['file_gb']:.2f} GB of "
          f"rows written under {root}", flush=True)
    assert out["file_gb"] <= SVC_BUDGET_GB, out["file_gb"]
    return out


def service_probe(cfg, ds, base) -> dict:
    """``--service-probe`` (not part of the default run): where a stale
    service's loss goes.  At 12 blocks and at SVC_DEPTH, 3 phases each of
    the vector trainer and of the service on one pool thread (the queue
    fixes the commit order) with (b)'s wire (int8, 4 fragments): at lag
    0, at lag 1, and at lag 1 without outer momentum; at SVC_DEPTH also
    twice (b)'s threads and preemptions at the default outer momentum
    0.9 (the thread order's share of the rise).  Per-phase mean
    losses, seconds and bytes of rows.  Each service run writes up to
    about 40 GB of rows at 12 blocks under tempfile's directory (TMPDIR),
    removed after the run."""
    out = {}
    for depth in sorted({cfg.num_layers, SVC_DEPTH}, reverse=True):
        c, b = cut_depth(cfg, base, depth)
        vec = make_trainer(c, DiPaCoConfig(levels=(2, 2), inner_steps=TAU),
                           ds, backend="vector", device="cuda",
                           base_params=b, batch_size=TRAIN_BATCH,
                           peak_lr=2e-3, warmup=TAU,
                           total_steps=SVC_PHASES * TAU)
        res = {"vector": [vec.run_phase().mean_loss
                          for _ in range(SVC_PHASES)]}
        del vec
        free_memory()
        runs = [("lag0", 0, 0.9, 1, 0.0), ("lag1", 1, 0.9, 1, 0.0),
                ("lag1_momentum0", 1, 0.0, 1, 0.0)]
        if depth == SVC_DEPTH:
            runs += [(f"b{i}", SVC_LAG, 0.9, SVC_THREADS, SVC_PREEMPT)
                     for i in range(2)]
        for name, lag, momentum, threads, preempt in runs:
            dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=TAU,
                                outer_fragments=SVC_FRAGMENTS,
                                fragment_stagger=1, comm_dtype="int8",
                                outer_momentum=momentum)
            root = tempfile.mkdtemp(prefix="dipaco-probe-")
            svc = make_trainer(c, dcfg, ds, backend="service", ckpt_root=root,
                               **svc_kwargs(b, num_workers=threads,
                                            max_phase_lag=lag,
                                            preempt_prob=preempt,
                                            seed=SVC_SEED))
            io0 = ckpt_db.io_stats()
            t0 = time.perf_counter()
            try:
                svc.run(SVC_PHASES - 1)
                svc.run(1)
                res[name] = phase_losses(svc, ds.num_shards)
                res[name + "_s"] = time.perf_counter() - t0
                res[name + "_file_gb"] = io_since(io0)["file_bytes"] / 1e9
                res[name + "_per_shard"] = {
                    f"{t},{s}": v for (t, s), v in sorted(svc.losses.items())}
            finally:
                svc.shutdown()
                shutil.rmtree(root, ignore_errors=True)
            del svc
            free_memory()
        out[depth] = res
        print(f"[service probe] {depth} blocks: {res}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 9: the deployment plane, hot swaps under the CUDA-graph tick, the
# serving fleet
# ---------------------------------------------------------------------------
# the device of phase 9 (tests/test_torch_chip_phase9.py rehearses its
# control flow on the CPU; on the card every check below runs)
DEV9 = "cuda"
# the deployment's base-init seed: a fleet member rebuilds the base
# weights from it
DEPLOY_SEED = 9
# (a)'s engine: 4 paths of 8 slots over a 256-token ring; requests of 64
# prompt tokens and 16 new
DEPLOY_SLOTS, DEPLOY_CACHE, DEPLOY_PROMPT, DEPLOY_NEW = 8, 256, 64, 16
# each worker's outer delta in (a): normal, this std (the weights' own
# is about 0.02 to 0.03); the planted candidate's module rows: normal
# noise of this std in place of every weight
DEPLOY_DELTA, DEPLOY_NOISE = 1e-3, 1.0
# the canary: 16 shadow documents of 128 tokens; a candidate passes with
# a shadow perplexity within 5% of the serving version's (greedy
# agreement is reported, not gated: a random model's near-flat logits
# flip their argmax under any change)
DEPLOY_SHADOW, DEPLOY_PPL_TOL = (16, 128), 1.05
# (c): 2 engine processes of 4 slots a path over a 128-token ring; 8
# requests half a second apart (each served alone, so that both fleets
# decode each request through the same sparse ticks)
FLEET_SIZE, FLEET_SLOTS, FLEET_CACHE, FLEET_GAP = 2, 4, 128, 0.5
# bytes: module rows (params bf16 + momentum f32, 1.63 GB a phase at 12
# blocks) and the registry's copy of each, the planted candidate's
# params-only rows (0.54 GB) and their copy, (b)'s barrier phase at 2
# blocks (2.76 GB in phase 8) and the copy of its module rows (0.41 GB):
# about 7.5 GB.  Phase 9 fails above DEPLOY_BUDGET_GB, and phases 8 and 9
# together above DEPLOY_TOTAL_GB (kept under a 45 GiB cap on one run's
# disk writes)
DEPLOY_BUDGET_GB, DEPLOY_TOTAL_GB = 8.0, 44.0
PHASE9_DIR = Path(__file__).resolve().parent / "build" / "phase9"


def sync9() -> None:
    if DEV9 == "cuda":
        torch.cuda.synchronize()


class TimedGate(CanaryGate):
    """The canary gate, counting its forwards (one a path with shadow
    documents, each launching flash attention once a block) and timing
    each evaluation."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.forwards, self.seconds = 0, []

    def _score(self, params, toks):
        self.forwards += 1
        return super()._score(params, toks)

    def evaluate(self, candidate_paths, serving_paths):
        t0 = time.perf_counter()
        rep = super().evaluate(candidate_paths, serving_paths)
        sync9()
        self.seconds.append(time.perf_counter() - t0)
        return rep


def time_installs(eng) -> None:
    """Record the seconds of each hot-swap install in ``eng.install_s``
    (the card synchronized on both sides)."""
    eng.install_s = []
    inner = eng._install

    def install(version, paths):
        sync9()
        t0 = time.perf_counter()
        inner(version, paths)
        sync9()
        eng.install_s.append(time.perf_counter() - t0)

    eng._install = install


def host_decodes(eng) -> int:
    """Decode steps the host dispatched (each launches flash decode once
    an attention block; a graph replay launches none from Python)."""
    s = eng.decode_stats
    return (s["dense"] - s["graph_replays"] + s["sparse_islands"]
            + s["looped_islands"])


def deploy_requests(cfg, n: int, seed: int, *, rid0: int = 0, paths=None,
                    gap: float = 0.0, prompt_len: int = DEPLOY_PROMPT,
                    max_new: int = DEPLOY_NEW) -> list:
    """``n`` corpus prompts, ``gap`` seconds apart; ``paths`` pre-routes
    them (else the engine's prompt-hash router does)."""
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=prompt_len, seed=0)
    prompts = corpus.sample_documents(n, seed=seed)
    return [Request(rid=rid0 + i, prompt=prompts[i], max_new=max_new,
                    arrival=i * gap,
                    path=None if paths is None else paths[i])
            for i in range(n)]


def run_to_end(eng, reqs) -> dict:
    """Submit ``reqs`` at once and step ``eng`` until they finish ->
    {rid: finished request} of ``reqs``."""
    for r in reqs:
        eng.submit(r)
    out = {}
    while not all(r.rid in out for r in reqs):
        for f in eng.step():
            out[f.rid] = f
    return {r.rid: out[r.rid] for r in reqs}


def tick_ms(records, tick: int) -> dict:
    """The ``serve.tick`` spans before, at and after ``tick``, in ms."""
    by = {r["args"]["tick"]: (r["t1"] - r["t0"]) / 1e6 for r in records
          if r.get("name") == "serve.tick"}
    return {"before": by.get(tick - 1), "during": by.get(tick),
            "after": by.get(tick + 1)}


def same_params(paths, ref) -> bool:
    return all(torch.equal(a, b) for p, q in zip(paths, ref)
               for a, b in zip(pytree.leaves(p), pytree.leaves(q)))


def deploy_swaps(card: str, root: Path) -> dict:
    """(a) dipaco-150m at full width (12 blocks, bf16, pallas), a 2x2
    partition: the registry's v1 is the base; one outer phase of small
    random deltas through ``ShardedOuterExecutors``, cut, canary-scored
    and promoted by ``Publisher.publish_cycle`` as v2 while a request
    is in flight on the engine (its dense tick captured at v1); the
    drain swap: the four requests admitted after it equal a fresh eager
    engine's on v2 and differ from v1's; a planted candidate of noise
    rows is rejected and quarantined; a rollback to v1 as a live swap
    flags the requests in flight, restores v1's weights bit for bit and
    the v1 run's tokens; the one-shot engine follows one promote."""
    cfg = get_config("dipaco-150m").replace(attn_impl="pallas",
                                            dtype="bfloat16")
    attn = cfg.num_layers
    dcfg = DiPaCoConfig(levels=(2, 2))
    PHASE9_DIR.mkdir(parents=True, exist_ok=True)
    reg = DeploymentRegistry(cfg, dcfg, str(root / "deploy"),
                             seed=DEPLOY_SEED, device=DEV9)
    v1 = reg.register(note="base").version
    reg.promote(v1)
    db = ckpt_db.CheckpointDB(str(root / "db"))
    store = ModuleStore(api.init_model(cfg, seed=DEPLOY_SEED, device=DEV9),
                        param_axes(cfg), reg.partition)
    execs = ShardedOuterExecutors(store, reg.partition, np.arange(4),
                                  ckpt_db=db)
    shadow = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DEPLOY_SHADOW[1], seed=0) \
        .sample_documents(DEPLOY_SHADOW[0], seed=5)
    gate = TimedGate(cfg, shadow, ppl_ratio_tol=DEPLOY_PPL_TOL,
                     min_agreement=0.0)
    pub = Publisher(db, reg, gate=gate)
    tel_path = PHASE9_DIR / "swaps.jsonl"
    tel = Telemetry(tel_path, fresh=True, meta={"run": "phase9 swaps"})
    opts = dict(cache_len=DEPLOY_CACHE, slots_per_path=DEPLOY_SLOTS,
                route_fn=prefix_hash_router(4))
    eng = ContinuousBatchingEngine(cfg, options=EngineOptions(
        registry=reg, swap_policy="drain", telemetry=tel, **opts))
    eng.warmup()
    assert (eng._graph is not None) == (DEV9 == "cuda")
    time_installs(eng)
    reset_counts()
    decoders = []            # (engine, host decodes before its runs)
    decoders.append((eng, host_decodes(eng)))
    out = {"card": card}
    # the v1 run: 8 requests at once on the simulated clock
    fins = eng.serve_trace(deploy_requests(cfg, 8, seed=11),
                           tick_dt=CB_SIM_DT)
    tok_v1 = {f.rid: f.tokens.tolist() for f in fins}
    assert {f.version for f in fins} == {v1}
    # A admitted on v1; then one outer phase lands and is published
    a = deploy_requests(cfg, 1, seed=12, rid0=100, paths=[0])[0]
    eng.submit(a)
    eng.step()
    assert a.rid in eng.in_flight
    gen = torch.Generator(device=DEV9).manual_seed(DEPLOY_SEED)
    like = store.assemble(0)
    sync9()
    t0 = time.perf_counter()
    for w in range(4):
        execs.accumulate(w, pytree.tree_map(
            lambda x: DEPLOY_DELTA * torch.randn(
                x.shape, generator=gen, device=DEV9), like), phase=0)
    sync9()
    out["outer_phase_s"] = time.perf_counter() - t0
    del like
    t0 = time.perf_counter()
    cycle = pub.publish_cycle()
    sync9()
    out["publish_cycle_s"] = time.perf_counter() - t0
    rep = cycle["report"]
    out["canary"] = {"seconds": gate.seconds[-1], "ppl": [
        rep.ppl_candidate, rep.ppl_serving], "agreement": rep.agreement}
    assert cycle["promoted"] == 2 and rep.passed, cycle
    v2 = 2
    # the drain swap: B (one request an island) waits while A drains
    b = deploy_requests(cfg, 4, seed=13, rid0=200, paths=[0, 1, 2, 3])
    for r in b:
        eng.submit(r)
    fins_a, paused = [], 0
    while not fins_a:
        fins_a = eng.step()
        if eng.in_flight:
            assert not any(r.rid in eng.in_flight for r in b)
            paused += 1
    assert fins_a[0].version == v1 and eng.version == v1
    replays0 = eng.decode_stats["graph_replays"]
    fins_b = {}
    while len(fins_b) < 4:
        for f in eng.step():
            fins_b[f.rid] = f
    drain_tick = eng.last_swap_tick
    assert eng.version == v2 and eng.swaps == 1
    assert {f.version for f in fins_b.values()} == {v2}
    if DEV9 == "cuda":
        # B decoded through the captured tick, after the swap
        assert eng.decode_stats["graph_replays"] > replays0, eng.decode_stats
    fresh = ContinuousBatchingEngine(cfg, options=EngineOptions(
        registry=reg, cuda_graph=False, **opts))
    decoders.append((fresh, 0))
    ref_b = run_to_end(fresh, deploy_requests(cfg, 4, seed=13, rid0=200,
                                              paths=[0, 1, 2, 3]))
    old = ContinuousBatchingEngine(cfg, reg.materialize(v1),
                                   options=EngineOptions(cuda_graph=False,
                                                         **opts))
    decoders.append((old, 0))
    old_b = run_to_end(old, deploy_requests(cfg, 4, seed=13, rid0=200,
                                            paths=[0, 1, 2, 3]))
    same = [fins_b[r].tokens.tolist() == ref_b[r].tokens.tolist()
            for r in fins_b]
    differ = sum(fins_b[r].tokens.tolist() != old_b[r].tokens.tolist()
                 for r in fins_b)
    out["drain"] = {"paused_ticks": paused, "equal_to_fresh_v2": sum(same),
                    "differ_from_v1": differ}
    assert all(same), "tokens after the drain swap differ from a fresh v2"
    assert differ > 0, "v2 does not change the drain requests' tokens"
    del fresh, old
    # the planted candidate: noise rows for every module at phase 1
    for (level, expert), ex in execs._all().items():
        noise = pytree.tree_map(
            lambda x: (DEPLOY_NOISE * torch.randn(
                x.shape, generator=gen, device=DEV9)).to(x.dtype),
            ex._params())
        db.write({"params": noise}, path_id=-1, phase=1, step=2,
                 kind="module", level=level, expert=expert,
                 extra={"updates": 2})
        del noise
    bad = pub.publish_cycle()
    rep = bad["report"]
    out["planted"] = {"rejected": bad["rejected"], "reason": rep.reason,
                      "ppl": [rep.ppl_candidate, rep.ppl_serving],
                      "canary_s": gate.seconds[-1]}
    assert bad["rejected"] == 3 and bad["promoted"] is None, bad
    assert not rep.passed and reg.manifest(3).signature in pub._quarantined
    assert reg.serving_version == v2
    assert pub.publish_cycle()["promoted"] is None     # quarantined
    pub.close()
    # a rollback to v1, installed live: the requests in flight are
    # re-prefilled on v1 and flagged
    eng.swap_policy = "live"
    c = deploy_requests(cfg, 8, seed=14, rid0=300)
    for r in c:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    inflight = set(eng.in_flight)
    assert inflight
    assert reg.rollback() == v1
    fins_c = {}
    while len(fins_c) < len(c):
        for f in eng.step():
            fins_c[f.rid] = f
    live_tick = eng.last_swap_tick
    assert eng.version == v1 and eng.swaps == 2
    assert all(fins_c[r].swapped_midstream for r in inflight)
    assert {f.version for f in fins_c.values()} == {v1}
    assert same_params(eng.paths, reg.materialize(v1)), \
        "paths after the rollback differ from v1's"
    fins = eng.serve_trace(deploy_requests(cfg, 8, seed=11),
                           tick_dt=CB_SIM_DT)
    assert {f.rid: f.tokens.tolist() for f in fins} == tok_v1, \
        "tokens after the rollback differ from the v1 run's"
    out["live"] = {"in_flight": len(inflight),
                   "flagged": sum(f.swapped_midstream
                                  for f in fins_c.values())}
    # the one-shot engine follows one promote
    prompts = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                              seq_len=32, seed=0).sample_documents(4,
                                                                   seed=17)
    one = CheckedEngine(cfg, options=EngineOptions(registry=reg,
                                                   cache_len=48))
    r1 = one.generate(prompts, max_new=8)
    assert one.version == v1
    reg.promote(v2)
    r2 = one.generate(prompts, max_new=8)
    assert one.version == v2
    fresh_one = CheckedEngine(cfg, options=EngineOptions(registry=reg,
                                                         cache_len=48))
    r2f = fresh_one.generate(prompts, max_new=8)
    assert np.array_equal(r2.tokens, r2f.tokens)
    assert bool(one.finite) and bool(fresh_one.finite)
    out["oneshot"] = {"differ_from_v1": int((r1.tokens != r2.tokens).sum())}
    launched = counts()
    sync9()
    decodes = (sum(host_decodes(e) - d0 for e, d0 in decoders)
               + one.decodes + fresh_one.decodes)
    if DEV9 == "cuda":
        want = {"flash_attention": attn * gate.forwards,
                "flash_decode": attn * decodes}
        got = {k: launched[k] for k in want}
        assert got == want and all(got.values()), (got, want)
    out["launches"] = launched
    out["install_s"] = eng.install_s
    tel.close()
    records = read_trace(tel_path)[0]
    out["swap_spans_ms"] = [(r["t1"] - r["t0"]) / 1e6 for r in records
                            if r.get("name") == "serve.swap"]
    out["tick_ms"] = {"drain": tick_ms(records, drain_tick),
                      "live": tick_ms(records, live_tick)}
    if DEV9 == "cuda":
        # the captured tick after the swaps: flash decode in its replays
        out["graph"] = graph_tick_profile(eng, attn)
    print(f"[deploy swaps] {out}", flush=True)
    del eng, one, fresh_one, store, execs
    return out


def deploy_training(card: str, root: Path, cfg, ds, base) -> dict:
    """(b) phase 8's cut (2 of 12 blocks): one barrier phase on one pool
    thread, on its own thread, while the engine (its tick captured
    before any thread starts) serves a stream of requests; the
    publisher's background thread cuts the phase, scores it and promotes
    it within one canary cycle, and the engine swaps to it."""
    cfg, base = cut_depth(cfg, base, SVC_DEPTH)
    dcfg = DiPaCoConfig(levels=(2, 2), inner_steps=TAU)
    bar = make_trainer(cfg, dcfg, ds, backend="barrier",
                       ckpt_root=str(root / "train"),
                       **svc_kwargs(base, num_workers=1, device=DEV9))
    reg = DeploymentRegistry(cfg, dcfg, str(root / "deploy_b"),
                             base_params=base, device=DEV9)
    shadow = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DEPLOY_SHADOW[1], seed=0) \
        .sample_documents(DEPLOY_SHADOW[0], seed=6)
    gate = TimedGate(cfg, shadow, ppl_ratio_tol=DEPLOY_PPL_TOL,
                     min_agreement=0.0)
    tel_path = PHASE9_DIR / "training.jsonl"
    tel = Telemetry(tel_path, fresh=True, meta={"run": "phase9 training"})
    pub = Publisher(bar.db, reg, gate=gate, telemetry=tel)
    eng = None
    try:
        v1 = pub.bootstrap().version
        eng = ContinuousBatchingEngine(cfg, options=EngineOptions(
            registry=reg, cache_len=DEPLOY_CACHE, slots_per_path=DEPLOY_SLOTS,
            route_fn=prefix_hash_router(4), telemetry=tel))
        eng.warmup()
        time_installs(eng)
        reset_counts()
        d0 = host_decodes(eng)
        pub.start(period=0.2)
        result = {}

        def train_one_phase():
            try:
                result["metrics"] = bar.run_phase()
            except BaseException as e:   # re-raised on the main thread
                result["error"] = e

        trainer = threading.Thread(target=train_one_phase, name="trainer",
                                   daemon=True)
        served, rid = [], 0
        t0 = time.perf_counter()
        trainer.start()
        deadline = t0 + 600.0
        while eng.version == v1:
            assert time.perf_counter() < deadline, "no swap within 600 s"
            assert "error" not in result, result["error"]
            if len(eng.in_flight) + eng.scheduler.pending < 4:
                eng.submit(deploy_requests(cfg, 1, seed=1000 + rid,
                                           rid0=rid, prompt_len=32,
                                           max_new=8)[0])
                rid += 1
            served += eng.step(now=time.perf_counter() - t0)
        swapped_s = time.perf_counter() - t0
        trainer.join()
        if "error" in result:
            raise result["error"]
        during = len(served)
        served += list(run_to_end(eng, deploy_requests(
            cfg, 4, seed=999, rid0=rid, prompt_len=32, max_new=8)).values())
        sync9()
        launched = counts()
        m = result["metrics"]
        v2 = eng.version
        pub.close()
        tel.close()
        records = read_trace(tel_path)[0]
        spans = {n: [r for r in records if r.get("name") == n]
                 for n in ("deploy.cycle", "deploy.canary", "serve.swap")}
        promoted = [r for r in records if r.get("name") == "deploy.promote"]
        cycle = next(r for r in spans["deploy.cycle"]
                     if r["args"].get("promoted") == v2)
        swap = spans["serve.swap"][0]
        out = {"card": card, "blocks": SVC_DEPTH,
               "mean_loss": m.mean_loss, "outer_updates": m["outer_updates"],
               "requests_served_while_training": during,
               "seconds_to_swap": swapped_s,
               "published": pub.published, "cycle_errors": pub.cycle_errors,
               "canary_s": [(r["t1"] - r["t0"]) / 1e9
                            for r in spans["deploy.canary"]],
               "cycle_s": (cycle["t1"] - cycle["t0"]) / 1e9,
               "promote_to_install_s": (swap["t1"] - promoted[0]["t"]) / 1e9,
               "publish_to_servable_s": (swap["t1"] - cycle["t0"]) / 1e9,
               "install_s": eng.install_s, "launches": launched,
               "tick_ms": tick_ms(records, eng.last_swap_tick)}
        print(f"[deploy training] {out}", flush=True)
        assert np.isfinite(m.mean_loss) and pub.cycle_errors == 0
        assert v2 == 2 and eng.swaps == 1 and pub.published == 1
        assert {f.version for f in served[during:]} == {v2}
        assert len(promoted) == 1 and len(spans["serve.swap"]) == 1
        if DEV9 == "cuda":
            check_launches(cfg, launched, ds.num_shards * TAU,
                           "deploy training")
            want = {"flash_attention": cfg.num_layers * gate.forwards,
                    "flash_decode": cfg.num_layers * (host_decodes(eng)
                                                      - d0)}
            got = {k: launched[k] for k in want}
            assert got == want and all(got.values()), (got, want)
        return out
    finally:
        pub.close()
        bar.shutdown()
        del eng
        free_memory()


def deploy_fleet(card: str, root: Path) -> dict:
    """(c) ``ServingFleet(size=2, backend="process")`` on (a)'s registry,
    on the card: its members' tokens equal the in-process fleet's on the
    same trace, and one promote (of the version served before) moves
    both members."""
    cfg = get_config("dipaco-150m").replace(attn_impl="pallas",
                                            dtype="bfloat16")
    reg = DeploymentRegistry(cfg, DiPaCoConfig(levels=(2, 2)),
                             str(root / "deploy"), seed=DEPLOY_SEED,
                             device=DEV9)
    v = reg.serving_version
    opts = EngineOptions(registry=reg, cache_len=FLEET_CACHE,
                         slots_per_path=FLEET_SLOTS)

    def trace():
        return deploy_requests(cfg, 8, seed=21, gap=FLEET_GAP,
                               prompt_len=32)

    inproc = ServingFleet(cfg, size=FLEET_SIZE, options=opts,
                          backend="inproc", warmup=True)
    ref = {f.rid: f.tokens.tolist() for f in inproc.serve_trace(trace())}
    del inproc
    free_memory()
    t0 = time.perf_counter()
    fleet = ServingFleet(cfg, size=FLEET_SIZE, options=opts,
                         backend="process", seed=DEPLOY_SEED, warmup=True)
    with fleet:
        out = {"card": card, "start_s": time.perf_counter() - t0}
        fins = fleet.serve_trace(trace())
        assert sorted(f.rid for f in fins) == sorted(ref)
        same = sum(f.tokens.tolist() == ref[f.rid] for f in fins)
        assert {f.version for f in fins} == {v}
        t1 = time.perf_counter()
        new = reg.promotion_history[-1]
        reg.promote(new)
        fleet.wait_version(new, timeout=120.0)
        out["promote_to_all_members_s"] = time.perf_counter() - t1
        after = fleet.serve_trace(deploy_requests(cfg, 4, seed=22,
                                                  gap=0.05, prompt_len=32))
        out.update(tokens_equal=same, requests=len(fins),
                   versions=fleet.versions(),
                   after_versions=sorted({f.version for f in after}),
                   latency_ms=percentiles([f.latency * 1e3 for f in fins]),
                   members=fleet.member_stats(), routed=fleet.stats)
    out["exitcodes"] = [p.exitcode for p in fleet._procs]
    print(f"[deploy fleet] {out}", flush=True)
    assert same == len(fins), "process fleet tokens differ from inproc"
    assert out["versions"] == [new] * FLEET_SIZE
    assert out["after_versions"] == [new]
    assert all(s["ticks"] > 0 for s in out["members"]), out["members"]
    assert out["exitcodes"] == [0] * FLEET_SIZE
    return out


def deploy(card: str, cfg, ds, base, phase8_gb: float) -> dict:
    """Phase 9: (a), (b) and (c) under one temporary directory, removed
    at the end; fails above its byte budgets."""
    root = Path(tempfile.mkdtemp(prefix="dipaco-phase9-"))
    io0 = ckpt_db.io_stats()
    t0 = time.perf_counter()
    try:
        out = {"swaps": deploy_swaps(card, root)}
        free_memory()
        out["training"] = deploy_training(card, root, cfg, ds, base)
        out["fleet"] = deploy_fleet(card, root)
        copies = sum(f.stat().st_size
                     for d in ("deploy", "deploy_b")
                     for f in (root / d / "modules").glob("*.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_memory()
    out["rows_gb"] = io_since(io0)["file_bytes"] / 1e9
    out["registry_copies_gb"] = copies / 1e9
    out["written_gb"] = out["rows_gb"] + out["registry_copies_gb"]
    out["phase8_and_9_gb"] = phase8_gb + out["written_gb"]
    out["seconds"] = time.perf_counter() - t0
    print(f"[deploy] {out['written_gb']:.2f} GB written ({out['rows_gb']:.2f}"
          f" of rows, {out['registry_copies_gb']:.2f} copied into the "
          f"registries), phases 8 and 9 {out['phase8_and_9_gb']:.2f} GB, "
          f"{out['seconds']:.1f} s", flush=True)
    assert out["written_gb"] <= DEPLOY_BUDGET_GB, out["written_gb"]
    assert out["phase8_and_9_gb"] <= DEPLOY_TOTAL_GB, out["phase8_and_9_gb"]
    return out


# ---------------------------------------------------------------------------
# Phase 10: the "mesh" backend on torch.distributed
# ---------------------------------------------------------------------------
# phase 4's dipaco-150m (bf16, pallas, remat), its shards and its base
# weights at full width: a 2x2 DiPaCo, 4 workers of batch 8, tau 4, K = 2
# fragments, the int8 wire.  (a) a world of one NCCL rank, all 12 blocks,
# 2 phases, against the single-process oracle bit for bit; (b) two gloo
# ranks sharing the card (NCCL refuses two ranks on one device), each
# with 2 of the 4 workers, against (a) bit for bit; (c) kill and resume at
# phase 8's cut, the phase-state files in /dev/shm (memory, not the
# machine's disk, whose 45 GiB of writes phases 8 and 9 nearly use up)
MESH_FRAGMENTS, MESH_COMM, MESH_PHASES, MESH_RANKS = 2, "int8", 2, 2
# (b)'s process-group timeout and join deadline: a hung collective fails
MESH_TIMEOUT_S = 600
MESH_SHM = Path("/dev/shm")
# (c) writes two state files of about 4.3 GB at 2 blocks
MESH_STATE_CAP_GB = 10.0


def device_sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def mesh_kwargs(base, dev: str) -> dict:
    return dict(base_params=base, batch_size=TRAIN_BATCH, peak_lr=2e-3,
                warmup=TAU, total_steps=MESH_PHASES * TAU, device=dev)


def mesh_dcfg() -> DiPaCoConfig:
    return DiPaCoConfig(levels=(2, 2), inner_steps=TAU,
                        outer_fragments=MESH_FRAGMENTS, comm_dtype=MESH_COMM)


def mesh_state(tr) -> dict:
    """The trees the oracle also holds, as leaf lists in the fragment
    spec's order (fragment states and residuals by leaf index)."""
    return {"worker": pytree.leaves(tr.worker_params),
            "global": pytree.leaves(tr.global_params),
            "opt": pytree.leaves({"m": tr.opt_state["m"],
                                  "v": tr.opt_state["v"]}),
            "frag_states": [s[i] for s in tr.frag_states for i in sorted(s)],
            "residuals": [tr.residuals[i] for i in sorted(tr.residuals)]}


def mesh_oracle(tr, cfg, ds, base, dev: str) -> dict:
    """``core.diloco.segmented_streaming_phase`` for MESH_PHASES phases
    from ``base``, driven by the same segment function (``launch.steps.
    make_segment_scan_fn``) on the same batches and rates, in one
    process: the mixing matrices and the schedule are ``tr``'s inputs."""
    W = ds.num_shards
    worker = stack_tree(base, W)
    glob = stack_tree(pytree.tree_map(lambda x: x.float(), base), W)
    opt = stack_tree(adamw_init(base), W)
    spec = FragmentSpec(glob, MESH_FRAGMENTS)
    states, resid = fragment_state_init(glob, spec), {}
    seg_fn = make_segment_scan_fn(cfg)
    bounds = segment_bounds(TAU, MESH_FRAGMENTS)
    d = tr.dcfg
    for ph in range(MESH_PHASES):
        batches = torch.as_tensor(np.stack(
            [phase_batches(ds.shards[i], TRAIN_BATCH, TAU, i, ph)
             for i in range(W)], axis=1), device=dev)
        lrs = torch.stack([tr.lr(ph * TAU + t) for t in range(TAU)]).to(dev)
        box = [opt]

        def inner_seg(s, wp):
            wp, box[0], _ = seg_fn(wp, box[0],
                                   batches[bounds[s]:bounds[s + 1]],
                                   lrs[bounds[s]:bounds[s + 1]])
            return wp

        worker, glob, states, resid = segmented_streaming_phase(
            inner_seg, worker, glob, states, resid, tr.axes, tr.mix_layers,
            tr.mix_shared, spec, comm_dtype=MESH_COMM, lr=d.outer_lr,
            momentum=d.outer_momentum, nesterov=d.outer_nesterov)
        opt = box[0]
    return {"worker": pytree.leaves(worker), "global": pytree.leaves(glob),
            "opt": pytree.leaves({"m": opt["m"], "v": opt["v"]}),
            "frag_states": [s[i] for s in states for i in sorted(s)],
            "residuals": [resid[i] for i in sorted(resid)]}


def mesh_differences(mine: dict, want: dict) -> dict:
    """Leaves that are not equal bit for bit, by tree: (leaf, max |a-b|,
    elements that differ)."""
    out = {}
    for k in want:
        assert len(mine[k]) == len(want[k]), (k, len(mine[k]), len(want[k]))
        bad = [(i, float((a.float() - b.float()).abs().max()),
                int((a != b).sum()))
               for i, (a, b) in enumerate(zip(mine[k], want[k]))
               if not torch.equal(a, b)]
        if bad:
            out[k] = bad
    return out


def gather_overlap(prof) -> dict:
    """From a profiled phase: the device time of work on the streams other
    than the compute stream (the gathers of a world of one NCCL rank:
    copies on NCCL's own stream), and how much of it ran while the
    compute stream was busy.  The ``nccl:`` spans, which annotate each
    collective around that work, are counted apart."""
    ev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        row = (e.device_resource_id(), e.start_ns(), e.end_ns(), e.name())
        (spans if e.name().startswith("nccl:") else ev).append(row)
    per_stream: dict = {}
    for sid, a, b, _ in ev:
        per_stream[sid] = per_stream.get(sid, 0) + (b - a)
    compute = max(per_stream, key=per_stream.get)
    busy = sorted((a, b) for sid, a, b, _ in ev if sid == compute)
    merged: list = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [m[0] for m in merged]
    other = [(a, b, n) for sid, a, b, n in ev if sid != compute]
    over = 0
    for a, b, _ in other:
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(merged) and merged[j][0] < b:
            over += max(0, min(b, merged[j][1]) - max(a, merged[j][0]))
            j += 1
    names: dict = {}
    for _, _, n in other:
        names[n[:60]] = names.get(n[:60], 0) + 1
    gather_ns = sum(b - a for a, b, _ in other)
    return {"gather_ms": gather_ns / 1e6, "overlap_ms": over / 1e6,
            "overlapping": over > 0, "events": len(other),
            "names": names, "compute_stream_busy_ms":
            sum(b - a for a, b in merged) / 1e6,
            "collectives": len(spans),
            "collective_span_ms": sum(b - a for _, a, b, _ in spans) / 1e6}


def mesh_one(card: str, cfg, ds, base, dev: str) -> dict:
    """(a) ``make_trainer(backend="mesh")`` in a world of one rank (NCCL
    on the card): 2 phases against the oracle bit for bit, the training
    kernels' launches, then a profiled third phase for the gathers'
    overlap."""
    free_memory()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tr = make_trainer(cfg, mesh_dcfg(), ds, backend="mesh",
                      **mesh_kwargs(base, dev))
    W = tr.num_workers
    assert tr.mesh.world == 1, tr.mesh
    assert tr.mesh.backend == ("nccl" if dev == "cuda" else "gloo"), tr.mesh
    phases, seconds = [], []
    for _ in range(MESH_PHASES):
        device_sync(dev)
        t0 = time.perf_counter()
        m = tr.run_phase()
        device_sync(dev)
        seconds.append(time.perf_counter() - t0)
        phases.append({"mean_loss": m.mean_loss, "final_loss": m.final_loss,
                       "per_path_loss": m.per_path_loss.tolist()})
    launched = counts()
    steps = W * TAU * MESH_PHASES
    out = {"card": card, "blocks": cfg.num_layers, "workers": W,
           "phases": phases, "phase_s": seconds,
           "step_s_share": [x / (W * TAU) for x in seconds],
           "launches": launched, "comm_stats": dict(tr.comm_stats)}
    if dev == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # the wire: what comm_stats counts (int8 payloads, per worker) against
    # fp32, and what each rank gathers (the dequantized f32 wire rows of
    # every worker, as the reference's all_gather)
    spec = tr._row_spec
    out["wire_bytes_int8"] = sum(spec.wire_bytes(f, MESH_COMM)
                                 for f in range(spec.num_fragments))
    out["wire_bytes_fp32"] = sum(spec.wire_bytes(f, "fp32")
                                 for f in range(spec.num_fragments))
    out["gathered_bytes_a_phase"] = sum(
        x.numel() * 4 for x in pytree.leaves(tr.global_params))
    losses = [p["mean_loss"] for p in phases]
    print(f"[mesh one] {out}", flush=True)
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses
    if dev == "cuda":
        check_launches(cfg, launched, steps, "mesh, a world of one")
    t0 = time.perf_counter()
    got = {k: [x.detach().clone() for x in v]
           for k, v in mesh_state(tr).items()}
    out["paths"] = [[x.cpu() for x in pytree.leaves(tr.path_params(p))]
                    for p in range(TRAIN_PATHS)]
    want = mesh_oracle(tr, cfg, ds, base, dev)
    out["oracle_s"] = time.perf_counter() - t0
    diff = mesh_differences(got, want)
    out["oracle_leaves"] = {k: len(v) for k, v in want.items()}
    out["oracle_differences"] = diff
    del got, want
    free_memory()
    print(f"[mesh one] against the oracle: {out['oracle_leaves']} leaves, "
          f"differences {diff}", flush=True)
    assert not diff, diff
    if dev == "cuda":
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run_phase()
            torch.cuda.synchronize()
            out["profiled_phase_s"] = time.perf_counter() - t0
        out["overlap"] = gather_overlap(prof)
        print(f"[mesh one] profiled phase {out['profiled_phase_s']:.2f} s, "
              f"gathers {out['overlap']}", flush=True)
    del tr
    free_memory()
    return out


def mesh_rank(rank: int, world: int, port: int, shm: str, cfg, ds,
              dev: str, threads: int) -> None:
    """(b)'s rank, in a spawned process: join the gloo world, train its
    2 of the 4 workers for MESH_PHASES phases, and (rank 0) save every
    path's parameters, the losses and the comm accounting."""
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        base = torch.load(f"{shm}/base.pt", map_location=dev)
        tr = make_trainer(cfg, mesh_dcfg(), ds, backend="mesh",
                          **mesh_kwargs(base, dev))
        assert (tr.mesh.world, tr.mesh.backend) == (world, "gloo"), tr.mesh
        t0 = time.perf_counter()
        losses = [tr.run_phase().mean_loss for _ in range(MESH_PHASES)]
        seconds = time.perf_counter() - t0
        paths = [[x.cpu() for x in pytree.leaves(tr.path_params(p))]
                 for p in range(TRAIN_PATHS)]
        if rank == 0:
            torch.save({"paths": paths, "losses": losses,
                        "comm_stats": dict(tr.comm_stats),
                        "rows": list(tr.rows), "seconds": seconds},
                       f"{shm}/rank0.pt")
    finally:
        dist.destroy_process_group()


def mesh_two(card: str, cfg, ds, base, one: dict, ref_paths, dev: str
             ) -> dict:
    """(b) two spawned gloo ranks on the card, 2 workers each: every
    path's parameters equal (a)'s bit for bit, the losses and the comm
    accounting too."""
    shm = Path(tempfile.mkdtemp(prefix="dipaco-mesh-", dir=MESH_SHM))
    try:
        torch.save(pytree.tree_map(lambda x: x.cpu(), base),
                   shm / "base.pt")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        ctx = mp.get_context("spawn")        # CUDA is not fork-safe
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, MESH_RANKS, port, str(shm), cfg, ds,
                                   dev, torch.get_num_threads()))
                 for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        end = time.monotonic() + MESH_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            assert not hung, f"ranks {hung} still ran after the deadline"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        assert codes == [0] * MESH_RANKS, f"rank exit codes {codes}"
        got = torch.load(shm / "rank0.pt")
    finally:
        shutil.rmtree(shm, ignore_errors=True)
    equal = [all(torch.equal(a, b) for a, b in zip(got["paths"][p],
                                                     ref_paths[p]))
             for p in range(TRAIN_PATHS)]
    out = {"card": card, "ranks": MESH_RANKS, "rows_of_rank0": got["rows"],
           "seconds": time.perf_counter() - t0,
           "rank0_train_s": got["seconds"], "losses": got["losses"],
           "comm_stats": got["comm_stats"], "paths_equal": equal}
    print(f"[mesh two ranks] {out}", flush=True)
    assert all(equal), equal
    assert got["losses"] == [p["mean_loss"] for p in one["phases"]]
    assert got["comm_stats"] == one["comm_stats"]
    return out


def mesh_resume(card: str, cfg, ds, base, dev: str) -> dict:
    """(c) at SVC_DEPTH blocks: 1 phase, drop the trainer, ``resume`` from
    its phase-state file, 1 more phase, against 2 uninterrupted phases
    bit for bit; the files live in memory (MESH_SHM)."""
    cfg, base = cut_depth(cfg, base, SVC_DEPTH)
    root = Path(tempfile.mkdtemp(prefix="dipaco-mesh-", dir=MESH_SHM))
    out = {"card": card, "blocks": SVC_DEPTH}
    try:
        ref = make_trainer(cfg, mesh_dcfg(), ds, backend="mesh",
                           **mesh_kwargs(base, dev))
        for _ in range(MESH_PHASES):
            ref.run_phase()
        want = {k: [x.detach().cpu() for x in v]
                for k, v in mesh_state(ref).items()}
        want_paths = [[x.cpu() for x in pytree.leaves(ref.path_params(p))]
                      for p in range(TRAIN_PATHS)]
        del ref
        free_memory()
        vic = make_trainer(cfg, mesh_dcfg(), ds, backend="mesh",
                           ckpt_root=str(root), **mesh_kwargs(base, dev))
        t0 = time.perf_counter()
        vic.run_phase()
        device_sync(dev)
        out["phase_with_save_s"] = time.perf_counter() - t0
        del vic                                           # the kill
        free_memory()
        t0 = time.perf_counter()
        res = make_trainer(cfg, mesh_dcfg(), ds, backend="mesh",
                           ckpt_root=str(root), resume=True,
                           **mesh_kwargs(base, dev))
        device_sync(dev)
        out["resume_s"] = time.perf_counter() - t0
        assert (res.phase, res.step) == (1, TAU), (res.phase, res.step)
        res.run_phase()
        got = {k: [x.detach().cpu() for x in v]
               for k, v in mesh_state(res).items()}
        paths = [[x.cpu() for x in pytree.leaves(res.path_params(p))]
                 for p in range(TRAIN_PATHS)]
        del res
        files = sorted(root.glob("mesh_phase_*.npz"))
        out["files"] = [f.name for f in files]
        out["file_gb"] = [f.stat().st_size / 1e9 for f in files]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_memory()
    out["differences"] = mesh_differences(got, want)
    out["paths_equal"] = [all(torch.equal(a, b) for a, b in zip(x, y))
                          for x, y in zip(paths, want_paths)]
    print(f"[mesh resume] {out}", flush=True)
    assert out["files"] == ["mesh_phase_000001.npz",
                            "mesh_phase_000002.npz"], out["files"]
    assert sum(out["file_gb"]) <= MESH_STATE_CAP_GB, out["file_gb"]
    assert not out["differences"], out["differences"]
    assert all(out["paths_equal"]), out["paths_equal"]
    return out


def mesh(card: str, cfg, ds, base, dev: str = "cuda") -> dict:
    """Phase 10: (a), (b) and (c); nothing written to the disk."""
    t0 = time.perf_counter()
    one = mesh_one(card, cfg, ds, base, dev)
    ref_paths = one.pop("paths")
    out = {"one": one,
           "two_ranks": mesh_two(card, cfg, ds, base, one, ref_paths, dev)}
    del ref_paths
    out["resume"] = mesh_resume(card, cfg, ds, base, dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"[mesh] {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 11: the other families at full width
# ---------------------------------------------------------------------------
# the device of phase 11 (tests/test_torch_chip_phase11.py rehearses it on
# the CPU at the smoke size; on the card the launch counts and the peak
# memory are checked and printed too)
DEV11 = "cuda"
# (name, paths served, blocks served (None: all), blocks of the f32
# prefill + decode check): bf16, attn_impl="pallas", phase 3's traffic
# through the one-shot engine as ``serve`` drives it, without the
# re-routed pass (the default run must end within the chip tool's 1200 s;
# with it the run took 1108.5 s on a slow host, PERF.md), then a profiled
# generate of PROFILE_PROMPT-token prompts.  jamba-v0.1-52b serves one
# period of its 8-block pattern (its 32 blocks are about 104 GB in bf16,
# a path of 8 about 24.7 GiB); moonshot-v1-16b-a3b's one path of 48
# blocks is about 53.3 GiB.  qwen3-8b, pixtral-12b and moonshot serve
# half their blocks (18 of 36, 20 of 40, 24 of 48), so that the default
# run ends within 1000 s on a slow host (PERF.md section 4).  gemma-2b: 18 blocks of 110.1 M parameters
# and a tied 256000 x 2048 embedding, about 5.0 GB a path.
# nemotron-4-340b: 4 of its 96 blocks (3.45 G parameters, 6.9 GB each)
# beside its two untied 256000 x 18432 tables (18.9 GB), about 46.5 GB;
# 8 blocks would be 74 GB beside the f32 layer drawn at init (13.8 GB);
# its f32 check at 1 block is about 52 GB.  qwen3-moe-235b-a22b: 8 of its
# 94 blocks (4.98 GB each, almost all its 128 experts) and 2.5 GB of
# tables, about 42.3 GB; its f32 check at 2 blocks about 25 GB
FAMILIES11 = (("dipaco-dense-1b", 1, None, 4), ("qwen3-8b", 2, 18, 4),
              ("pixtral-12b", 1, 20, 4),
              ("moonshot-v1-16b-a3b", 1, 24, 4),
              ("jamba-v0.1-52b", 2, 8, 8),
              ("gemma-2b", 2, None, 4),
              ("nemotron-4-340b", 1, 4, 1),
              ("qwen3-moe-235b-a22b", 1, 8, 2))
# one inner step's gradients, kernels vs plain, (name, blocks, dtypes):
# jamba at 8 blocks in bf16 only (a 4-block cut holds no attention block,
# and 8 blocks in f32 do not fit beside their gradients).  gemma-2b at 4
# blocks; nemotron-4-340b at 1 block in bf16 only (25.8 GB of weights,
# two untied 256000 x 18432 tables of 9.4 GB each and a 6.9 GB block; in
# f32 its weights beside their gradients would be 103 GB);
# qwen3-moe-235b-a22b at 2 blocks in bf16 (12.5 GB) and 1 in f32 (15 GB)
GRAD11 = (("qwen3-8b", 4, ("float32", "bfloat16")),
          ("pixtral-12b", 4, ("float32", "bfloat16")),
          ("moonshot-v1-16b-a3b", 4, ("float32", "bfloat16")),
          ("whisper-base", 4, ("float32", "bfloat16")),
          ("jamba-v0.1-52b", 8, ("bfloat16",)),
          ("gemma-2b", 4, ("float32", "bfloat16")),
          ("nemotron-4-340b", 1, ("bfloat16",)),
          ("qwen3-moe-235b-a22b", 2, ("bfloat16",)),
          ("qwen3-moe-235b-a22b", 1, ("float32",)))
# gemma-2b is trained at all 18 blocks through make_trainer(backend=
# "vector") by ``train_family``: levels (1,), GEMMA_TRAIN_BATCH,
# FAMILY_PHASES phases of FAMILY_TAU.  nemotron-4-340b and
# qwen3-moe-235b-a22b are not trained through make_trainer: the two f32
# AdamW moments of nemotron's tables alone are 75 GB, and one block of
# qwen3-moe with its tables already needs about 75 GB of trainer state
# and weights
# pixtral's patch stub: requests through api.prefill with the config's
# patch positions and this many text tokens; its gradient check's batch
# carries this many patch positions of its 1024-token documents
PATCH_REQUESTS, PATCH_TEXT, GRAD_PATCHES = 2, 64, 256
# whisper-base: requests of the config's 1500 frames, the prompt replayed
# token by token (the reference's encoder-decoder prefill), then MAX_NEW
# new tokens
WHISPER_REQUESTS, WHISPER_PROMPT = 8, 16
# the paper's dense baseline trained at all 24 blocks: one path, one
# worker (levels (1,)), phase 4's documents as one shard, its batch, tau
# and phases
DENSE_DOCS = DOCS


def bf16_tol(blocks: int) -> float:
    """prefill + decode, kernels vs plain, in bf16: one rounding of each
    kernel output carried through the blocks (PERF.md section 2)."""
    return 0.25 if blocks <= 12 else 1.0


def patch_prefill(cfg) -> dict:
    """pixtral's patch stub: PATCH_REQUESTS requests of the config's patch
    positions (embeddings from a seed) and PATCH_TEXT text tokens through
    ``api.prefill``, then MAX_NEW ``serve_step``s fed the documents' next
    tokens, through the kernels and through the plain path; the logits
    must agree within the bf16 bar and flash decode launch once a block
    and step (the prefill attends through the dense masked branch)."""
    n, b = cfg.vision.num_patches, PATCH_REQUESTS
    s = n + PATCH_TEXT
    params = api.init_model(cfg, seed=7, device=DEV11)
    gen = torch.Generator(device=DEV11).manual_seed(8)
    patches = torch.randn((b, n, cfg.vision.d_patch), generator=gen,
                          device=DEV11).to(torch.bfloat16)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=s + MAX_NEW, seed=3)
    toks = torch.as_tensor(corpus.sample_documents(b), device=DEV11)
    out, logits = {"patches": n, "text": PATCH_TEXT, "requests": b}, {}
    with torch.inference_mode():
        for impl in ("pallas", "full"):
            c = cfg.replace(attn_impl=impl)
            reset_counts()
            sync(DEV11)
            t0 = time.perf_counter()
            lg, cache = api.prefill(params, c, {"tokens": toks[:, :s],
                                                "patch_embeds": patches},
                                    s + MAX_NEW)
            sync(DEV11)
            prefill_s = time.perf_counter() - t0
            steps, step_s = [lg[:, -1].float()], []
            for t in range(MAX_NEW):
                t0 = time.perf_counter()
                lg, cache = api.serve_step(params, c, {
                    "tokens": toks[:, s + t:s + t + 1]}, cache, s + t)
                sync(DEV11)
                step_s.append(time.perf_counter() - t0)
                steps.append(lg[:, -1].float())
            logits[impl] = torch.stack(steps)
            out[impl] = {"prefill_s": prefill_s,
                         "decode_step_ms_median": float(
                             np.median(step_s)) * 1e3,
                         "launches": counts()}
    assert torch.isfinite(logits["pallas"]).all()
    out["max_abs_dlogit"] = (logits["pallas"] - logits["full"]).abs().max(
        ).item()
    out["tol"] = bf16_tol(cfg.num_layers)
    print(f"[patches {cfg.name}] {out}", flush=True)
    assert out["max_abs_dlogit"] <= out["tol"], out
    if DEV11 == "cuda":
        got = out["pallas"]["launches"]
        assert got["flash_decode"] == cfg.num_layers * MAX_NEW, got
        assert got["flash_attention"] == 0, got
    del params, cache
    free_memory()
    return out


def family11(name: str, num_paths: int, depth, f32_depth: int) -> dict:
    """One decoder family: served at full width (the plain pass, launch
    counts exact, a profiled generate), then prefill + MAX_NEW
    decodes through the kernels against the plain path in bf16 at the
    served depth and in f32 at ``f32_depth`` blocks; pixtral's patch stub
    besides."""
    t0 = time.perf_counter()
    cfg = cut_layers(get_config(name).replace(attn_impl="pallas",
                                              dtype="bfloat16"), depth)
    out = {"blocks": cfg.num_layers, "paths": num_paths,
           "serve": serve(cfg, num_paths, PROFILE_PROMPT, reroute=False,
                          dev=DEV11)}
    out["parity"] = {
        "bfloat16": prefill_decode_parity(cfg, "bfloat16",
                                          bf16_tol(cfg.num_layers),
                                          dev=DEV11),
        "float32": prefill_decode_parity(cfg, "float32", 1e-3,
                                         depth=f32_depth, dev=DEV11)}
    if cfg.vision is not None:
        out["patches"] = patch_prefill(cfg)
    out["seconds"] = time.perf_counter() - t0
    print(f"[families] {name}: {out['seconds']:.1f} s", flush=True)
    return out


def whisper_frames(cfg, batch: int, seed: int):
    enc = cfg.encoder
    gen = torch.Generator(device=DEV11).manual_seed(seed)
    return torch.randn((batch, enc.source_len, enc.d_source), generator=gen,
                       device=DEV11).to(torch_dtype(cfg.dtype))


def whisper_extras(params, cfg) -> dict:
    """The decode batch's encoder side: the encoder output of seeded
    frames and the cross K/V built from it once."""
    enc_out = encdec.encode(params, cfg, whisper_frames(cfg, REQUESTS, 4))
    return {"enc_out": enc_out,
            "cross_kv": encdec.build_cross_cache(params, cfg, enc_out)}


def whisper11() -> dict:
    """whisper-base through ``models.api``, as the reference runs it:
    WHISPER_REQUESTS requests of 1500 frames, the encoder once, the
    cross K/V once, a WHISPER_PROMPT-token prompt replayed through
    ``api.prefill``, then MAX_NEW greedy tokens; once with ``cross_kv``
    and once recomputing it from ``enc_out`` every step (fed the first
    run's tokens): the logits must agree within the bf16 bar, flash
    decode launch once a decoder block and step.  Then the kernels
    against the plain path, bf16 at 6 + 6 blocks and f32 at 4 + 4."""
    t_start = time.perf_counter()
    cfg = get_config("whisper-base").replace(attn_impl="pallas",
                                             dtype="bfloat16")
    b, s = WHISPER_REQUESTS, WHISPER_PROMPT
    reset_peak(DEV11)
    t0 = time.perf_counter()
    params = api.init_model(cfg, seed=0, device=DEV11)
    sync(DEV11)
    out = {"init_s": time.perf_counter() - t0, "requests": b, "prompt": s,
           "frames": cfg.encoder.source_len}
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=s, seed=2)
    prompts = torch.as_tensor(corpus.sample_documents(b), device=DEV11)
    frames = whisper_frames(cfg, b, 1)
    logits, greedy = {}, []
    with torch.inference_mode():
        for warm in (True, False):
            sync(DEV11)
            t0 = time.perf_counter()
            enc_out = encdec.encode(params, cfg, frames)
            cross = encdec.build_cross_cache(params, cfg, enc_out)
            sync(DEV11)
            out["encode_s"] = time.perf_counter() - t0
            for run in ("cross_kv", "enc_out"):
                extra = {"enc_out": enc_out}
                if run == "cross_kv":
                    extra["cross_kv"] = cross
                reset_counts()
                step_s = []
                t0 = time.perf_counter()
                lg, cache = api.prefill(params, cfg, {"tokens": prompts,
                                                      **extra}, s + MAX_NEW)
                steps = [lg[:, -1].float()]
                for t in range(2 if warm else MAX_NEW):
                    if run == "cross_kv":
                        greedy.append(torch.argmax(lg[:, -1], dim=-1))
                    t1 = time.perf_counter()
                    lg, cache = api.serve_step(params, cfg, {
                        "tokens": greedy[t][:, None], **extra}, cache, s + t)
                    sync(DEV11)
                    step_s.append(time.perf_counter() - t1)
                    steps.append(lg[:, -1].float())
                sync(DEV11)
                dt = time.perf_counter() - t0
                if warm:
                    continue
                logits[run] = torch.stack(steps)
                out[run] = {"tokens_per_s": b * MAX_NEW / dt, "seconds": dt,
                            "decode_steps": s + MAX_NEW,
                            "decode_step_ms_median": float(
                                np.median(step_s)) * 1e3,
                            "launches": counts()}
            if warm:
                greedy.clear()
    out["peak_memory_gib"] = peak_gib(DEV11)
    assert torch.isfinite(logits["cross_kv"]).all()
    out["max_abs_dlogit_cross_kv"] = (logits["cross_kv"]
                                      - logits["enc_out"]).abs().max().item()
    out["tol"] = bf16_tol(cfg.num_layers)
    print(f"[whisper] {out}", flush=True)
    assert out["max_abs_dlogit_cross_kv"] <= out["tol"], out
    if DEV11 == "cuda":
        for run in ("cross_kv", "enc_out"):
            got = out[run]["launches"]
            assert got["flash_decode"] == cfg.num_layers * (s + MAX_NEW), got
            assert got["flash_attention"] == 0, got
    del params, cache, enc_out, cross
    free_memory()
    out["parity"] = {
        dt: prefill_decode_parity(cfg, dt, tol, prompt_len=s, depth=depth,
                                  extras=whisper_extras, dev=DEV11)
        for dt, tol, depth in (("bfloat16", bf16_tol(cfg.num_layers), None),
                               ("float32", 1e-3, 4))}
    out["seconds"] = time.perf_counter() - t_start
    return out


def grad_extras(name: str):
    """The gradient check's batch entries besides the tokens: seeded
    frames for whisper-base, GRAD_PATCHES patch embeddings for pixtral."""
    if name == "whisper-base":
        return lambda cfg, gen: {"frames": torch.randn(
            (2, cfg.encoder.source_len, cfg.encoder.d_source), generator=gen,
            device=gen.device)}
    if name == "pixtral-12b":
        return lambda cfg, gen: {"patch_embeds": torch.randn(
            (2, GRAD_PATCHES, cfg.vision.d_patch), generator=gen,
            device=gen.device)}
    return None


def train_dense11() -> dict:
    """The paper's dense baseline trained at all 24 blocks through
    ``make_trainer(backend="vector")``: levels (1,) (one path, one
    worker), DENSE_DOCS synthetic documents of DOC_LEN tokens as one
    shard, batch TRAIN_BATCH, PHASES phases of TAU, remat on.  The loss
    must fall; the LSE forward launches twice a block and step (remat),
    dK/dV and dQ once."""
    cfg = get_config("dipaco-dense-1b").replace(
        attn_impl="pallas", dtype="bfloat16", route_prefix_len=32,
        remat=True)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, num_domains=4,
                             seq_len=DOC_LEN, seed=0)
    docs = corpus.sample_documents(DENSE_DOCS)
    ds = shard_documents(docs, np.zeros(len(docs), np.int64), 1)
    reset_peak(DEV11)
    base = api.init_model(cfg, seed=0, device=DEV11)
    tr = make_trainer(cfg, DiPaCoConfig(levels=(1,), inner_steps=TAU), ds,
                      backend="vector", device=DEV11, base_params=base,
                      batch_size=TRAIN_BATCH, peak_lr=2e-3, warmup=TAU,
                      total_steps=PHASES * TAU)
    del base
    timer = tr._step_fn = TimedStep(tr._step_fn, DEV11)
    reset_counts()
    t0 = time.perf_counter()
    phases = [tr.run_phase() for _ in range(PHASES)]
    sync(DEV11)
    launched = counts()
    steps = tr.num_workers * TAU * PHASES
    out = {"blocks": cfg.num_layers, "workers": tr.num_workers,
           "batch": TRAIN_BATCH, "docs": len(docs),
           "phases": [{"mean_loss": m.mean_loss, "final_loss": m.final_loss}
                      for m in phases],
           "seconds": time.perf_counter() - t0,
           "inner_step_s_median": float(np.median(timer.seconds)),
           "inner_step_s_all": timer.seconds,
           "tokens_per_s": TRAIN_BATCH * DOC_LEN / float(
               np.median(timer.seconds)),
           "peak_memory_gib": peak_gib(DEV11), "launches": launched}
    print(f"[train dipaco-dense-1b] {out}", flush=True)
    losses = [p["mean_loss"] for p in out["phases"]]
    assert tr.num_workers == 1 and all(np.isfinite(losses)), out
    assert losses[1] < losses[0], losses
    if DEV11 == "cuda":
        want = {"flash_attention_lse": 2 * cfg.num_layers * steps,
                "flash_attention_dkv": cfg.num_layers * steps,
                "flash_attention_dq": cfg.num_layers * steps}
        assert {k: launched[k] for k in want} == want, (launched, want)
    del tr
    free_memory()
    return out


def family_launches(rows, fam) -> None:
    """Phase 11's launch counts into phase 2's rows of its shapes, each
    counted where the main path ran that shape: flash decode at G 4 D 128
    in the GQA families' serving runs' decode steps of the row's batch,
    flash decode at a last three family's heads in its own decode steps
    of the row's batch and flash attention in its routing calls,
    the LSE forward, dK/dV and dQ in the dense baseline's and gemma-2b's
    training and in the bf16 gradient checks of nemotron-4-340b and
    qwen3-moe-235b-a22b (which are not trained), the expert GEMM in the MoE families' serving runs' decode steps of the
    row's capacity (dropless: C requests) and in their routing calls,
    dX and dW in their bf16 gradient checks.  On the card a row whose
    shape the run never launched fails it."""
    def served(family, call, kernel):
        by_call = fam[family]["serve"]["plain"]["launches_by_call"]
        return sum(n[kernel] for c, n in by_call.items()
                   if c == call or c.startswith(call + ":"))

    for row in rows:
        kernel, family = row["name"].split(":")[:2]
        if kernel == "flash_decode" and family in fam:
            row["launches"] = served(family, f"decode:{row['shape'][0]}",
                                     kernel)
        elif kernel == "flash_decode":
            call = f"decode:{row['shape'][0]}"
            row["launches_by_family"] = {
                f: served(f, call, kernel)
                for f in ("qwen3-8b", "pixtral-12b", "jamba-v0.1-52b")}
            row["launches"] = sum(row["launches_by_family"].values())
        elif kernel == "flash_attention":
            row["launches"] = served(family, "features", kernel)
        elif kernel.startswith("flash_attention"):
            run = fam[family].get("train") or \
                fam[family]["train_grad_parity"]["bfloat16"]
            row["launches"] = run["launches"][kernel]
        elif kernel == "expert_gemm":
            row["launches"] = served(
                family, f"decode:{row['shape'][1]}"
                if row["name"].endswith("decode") else "features", kernel)
        else:
            row["launches"] = fam[family]["train_grad_parity"]["bfloat16"][
                "launches"][kernel]
        if DEV11 == "cuda":
            assert row["launches"] > 0, (row["name"], row["shape"])


def families11() -> dict:
    """Phase 11: each decoder family, whisper-base, the dense baseline's
    and gemma-2b's training, and the gradient checks; each family's
    weights freed before the next family's are drawn.  Nothing is written
    to the disk."""
    t_start = time.perf_counter()
    out = {}
    for name, num_paths, depth, f32_depth in FAMILIES11:
        out[name] = family11(name, num_paths, depth, f32_depth)
    out["whisper-base"] = whisper11()
    t0 = time.perf_counter()
    out["dipaco-dense-1b"]["train"] = train_dense11()
    print(f"[families] train dipaco-dense-1b: {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    t0 = time.perf_counter()
    out["gemma-2b"]["train"] = train_family(
        "gemma-2b", DiPaCoConfig(levels=(1,), inner_steps=FAMILY_TAU),
        GEMMA_TRAIN_BATCH, None, dev=DEV11, peak_lr=GEMMA_PEAK_LR)
    print(f"[families] train gemma-2b: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    for name, depth, dtypes in GRAD11:
        out[name].setdefault("train_grad_parity", {}).update({
            dt: family_grad_parity(name, dt, depth, grad_extras(name),
                                   dev=DEV11) for dt in dtypes})
    print(f"[families] gradient checks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    out["seconds"] = time.perf_counter() - t_start
    print(f"[families] {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 12: Algorithm 1 and the paper's variants at full width
# ---------------------------------------------------------------------------
# the device of phase 12 (tests/test_torch_chip_phase12.py rehearses it on
# the CPU at the smoke size; on the card the launch counts are checked too)
DEV12 = "cuda"
# (a) ``repro_torch.examples.train_dipaco`` at ``--preset paper``
# (dipaco-150m, bf16, remat, attn_impl="pallas" on the card; 2048
# documents of 256 tokens, levels 2x2, batch 8, its 256 router and 256
# validation documents), 4 phases of tau 4 (the preset's 100 is for real
# runs); (b) each variant 4 workers of batch 8, 2 phases of tau 4
ALG1_DOCS, ALG1_PHASES, ALG1_TAU, ALG1_BATCH = 2048, 4, 4, 8
VARIANT_PHASES = 2
# (a)'s worker-stacked dumps and (c)'s registry go to memory, not to the
# machine's disk, whose 45 GiB of writes phases 8 and 9 nearly use up;
# (a)'s four dumps of 4 workers' bf16 weights are about 4.6 GB
SHM12 = "/dev/shm"
ALG1_DUMP_CAP_GB = 10.0
# Table 3's protocol on (a)'s best paths: re-route once per sequence
# (None: every = the documents' length), every 16 and every 8 tokens
REROUTE12 = (None, 16, 8)
# workers that share a module must hold it bit for bit after every outer
# step, and get the same bits of its mixed gradient at every step of the
# sync trainer: the same mixing row and the same inputs give the same
# bits; tests/test_torch_examples.py shows both packages hold it so on
# the CPU
# (c) the other four examples at their scripts' sizes, and
# multiarch_smoke over all twelve configs
EXAMPLES12 = {"quickstart": {}, "serve_paths": {}, "train_and_serve": {},
              "multiarch_smoke": {"archs": ALL_CONFIGS}}


def sharing_mismatch(worker_params, axes, mix_layers, mix_shared) -> dict:
    """Every module that two workers share (a nonzero mixing weight
    between them: ``mix_layers[r, w, v]`` for repeat r of a layer leaf,
    ``mix_shared[w, v]`` for the other leaves) compared between the two:
    -> {"pairs": modules compared, "elements", "differ": elements that
    differ, "max_bf16_ulps": the largest difference in bf16 ulps of the
    larger value}."""
    R = mix_layers.shape[0]
    ml = (torch.as_tensor(mix_layers) != 0).cpu()
    ms = (torch.as_tensor(mix_shared) != 0).cpu()
    out = {"pairs": 0, "elements": 0, "differ": 0, "max_bf16_ulps": 0.0}

    def compare(a, b):
        out["pairs"] += 1
        out["elements"] += a.numel()
        d = a != b
        n = int(d.sum())
        if n:
            af, bf = a[d].float(), b[d].float()
            ulp = torch.exp2(torch.floor(torch.log2(
                torch.maximum(af.abs(), bf.abs()))) - 7)
            out["differ"] += n
            out["max_bf16_ulps"] = max(out["max_bf16_ulps"], float(
                ((af - bf).abs() / ulp).max()))

    def leaf(x, ax):
        layer = bool(ax) and ax[0] == LAYERS and x.ndim >= 2 \
            and x.shape[1] == R
        for w in range(x.shape[0]):
            for v in range(w + 1, x.shape[0]):
                if layer:
                    for r in range(R):
                        if ml[r, w, v]:
                            compare(x[w, r], x[v, r])
                elif ms[w, v]:
                    compare(x[w], x[v])

    pytree.tree_map(leaf, worker_params, axes,
                    is_leaf=lambda x: isinstance(x, tuple))
    return out


def forward_calls(n: int, batch: int) -> int:
    return -(-n // batch)


def alg1_forwards(out) -> int:
    """The no-grad forwards of ``train_dipaco.run`` (flash attention
    launches once a block in each): the routing features of the
    documents (batches of 64), every phase's holdout losses (the first
    64 of each worker's holdout, batches of 32; the new shards' after the
    re-shard), ``score_documents`` (every path, batches of 32), the
    router's and the validation documents' features, and the routed
    evaluation (each path's documents, batches of 32)."""
    tr = out["trainer"]

    def holdouts(ds):
        return sum(forward_calls(min(len(h), 64), 32) for h in ds.holdouts)

    cut = out["reshard_phase"] + 1
    n = forward_calls(len(out["docs"]), 64)
    n += cut * holdouts(out["dataset"])
    n += (len(out["phases"]) - cut) * holdouts(tr.dataset)
    n += tr.partition.num_paths * forward_calls(len(out["router_docs"]), 32)
    n += forward_calls(len(out["router_docs"]), 64)
    n += forward_calls(len(out["val"]), 64)
    n += sum(forward_calls(int(c), 32) for c in np.bincount(out["val_assign"]))
    return n


def alg1_losses(out, kept) -> dict:
    """Every phase's mean training loss finite, falling from the first
    phase to the second; and the loss on the new shards falling from the
    third phase to the fourth: each worker's held-out loss on its new
    shard's holdout (the documents early stopping scores, the same at
    every phase), averaged over the workers.  A phase's mean training
    loss (tau 4 steps of batch 8, other documents each phase) moves by
    more than that between phases (PERF.md, PR 27).  The held-out losses
    on the first shards are printed beside them."""
    tr, cfg = out["trainer"], out["cfg"]
    means = [p["mean_loss"] for p in out["phases"]]
    held = {}
    for name, ds in (("first_shards", out["dataset"]),
                     ("new_shards", tr.dataset)):
        held[name] = [[mean_nll(row(kept[ph], w), cfg, h[:64])
                       for w, h in enumerate(ds.holdouts) if len(h)]
                      for ph in sorted(kept)]
    res = {"phase_means": means, "holdout_by_phase": held,
           "holdout_mean_by_phase": {k: [float(np.mean(r)) for r in v]
                                     for k, v in held.items()}}
    print(f"[alg1 losses] phase means {means}; held-out by phase, mean "
          f"over workers {res['holdout_mean_by_phase']}", flush=True)
    assert np.isfinite(means).all() and means[1] < means[0], res
    new = res["holdout_mean_by_phase"]["new_shards"]
    assert np.isfinite(new).all() and new[-1] < new[-2], res
    return res


def alg1_scoring(out, params) -> dict:
    """``score_documents`` at the re-shard (through the kernels on the
    card) against the same call through the plain attention on the same
    weights.  The bar is phase 2's bf16 bar on each scored token, so on
    a document's sum of them; the argmax may differ only where the plain
    scores' top two are closer than that bar."""
    cfg, tr = out["cfg"], out["trainer"]
    paths = [row(params, tr.worker_of_path(p))
             for p in range(tr.partition.num_paths)]
    plain = score_documents(paths, cfg.replace(attn_impl="chunked"),
                            out["router_docs"]).float()
    got = out["scores"].float()
    scored = out["router_docs"].shape[1] - cfg.route_prefix_len
    bar = TOL[torch.bfloat16] * scored
    top2 = torch.topk(plain, 2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    differ = got.argmax(1) != plain.argmax(1)
    res = {"max_abs_err": float((got - plain).abs().max()),
           "mean_abs_err": float((got - plain).abs().mean()),
           "score_scale": float(plain.abs().max()), "bar": bar,
           "scored_tokens": scored, "argmax_flips": int(differ.sum()),
           "wrong_flips": int((differ & (gap > bar)).sum()),
           "min_top2_gap": float(gap.min())}
    print(f"[alg1 scoring] kernels vs plain attention: {res}", flush=True)
    assert res["max_abs_err"] <= bar and res["wrong_flips"] == 0, res
    return res


def alg1_early_stopping(out, kept) -> dict:
    """``path_params(p, best=True)`` must equal, bit for bit, the
    parameters its worker held after the phase of its lowest holdout
    loss (the last phase at which the running minimum fell)."""
    tr = out["trainer"]
    hist = np.stack([p["best_holdout"] for p in out["phases"]])
    best = [max(ph for ph in range(len(hist))
                if ph == 0 or hist[ph, w] < hist[ph - 1, w])
            for w in range(tr.num_workers)]
    for p in range(tr.partition.num_paths):
        w = tr.worker_of_path(p)
        assert same_params([tr.path_params(p, best=True)],
                           [row(kept[best[w]], w)]), (p, w, best)
    res = {"best_phase": best, "best_holdout_by_phase": hist.tolist()}
    print(f"[alg1 early stopping] {res}", flush=True)
    return res


def alg1_dumps(out) -> dict:
    """One full dump a phase; the last, read back, equals the workers'
    parameters bit for bit; all of them within ALG1_DUMP_CAP_GB."""
    db, tr = out["db"], out["trainer"]
    rows = db.rows(kind="full")
    assert [r.phase for r in rows] == list(range(len(out["phases"]))), rows
    t0 = time.perf_counter()
    back = train_dipaco.restore_dump(db, tr.worker_params)
    sync(DEV12)
    res = {"rows": len(rows), "gb": db.nbytes() / 1e9,
           "read_back_s": time.perf_counter() - t0,
           "bit_equal": same_params([back], [tr.worker_params])}
    print(f"[alg1 dumps] {res}", flush=True)
    assert res["bit_equal"] and res["gb"] <= ALG1_DUMP_CAP_GB, res
    return res


def alg1_rerouted(out) -> dict:
    """Table 3's protocol on the best paths with the discriminative
    router of the re-shard: route once per sequence, every 16 and every
    8 tokens."""
    tr, cfg, val = out["trainer"], out["cfg"], out["val"]
    paths = [tr.path_params(p, best=True)
             for p in range(tr.partition.num_paths)]
    res = {}
    for every in REROUTE12:
        t0 = time.perf_counter()
        r = evaluate_rerouted(paths, cfg, out["router"], out["base"], val,
                              every=every or val.shape[1])
        sync(DEV12)
        r["seconds"] = time.perf_counter() - t0
        res[f"every_{every}" if every else "once"] = r
        print(f"[alg1 reroute] {'once' if every is None else every}: "
              f"nll {r['nll']:.4f} ppl {r['ppl']:.3f} switch rate "
              f"{r['switch_rate']:.4f} ({r['seconds']:.1f} s)", flush=True)
        assert np.isfinite(r["nll"]), r
    return res


def alg1(card: str) -> tuple:
    """(a): the example's Algorithm 1 run with its re-shard, early
    stopping and dumps, then the checks.  -> (results, the run's data
    for (b), its trainer dropped)."""
    root = tempfile.mkdtemp(prefix="dipaco-phase12-", dir=SHM12)
    kept = {}

    def keep(ph, tr):
        kept[ph] = pytree.tree_map(torch.clone, tr.worker_params)

    reset_counts()
    reset_peak(DEV12)
    t0 = time.perf_counter()
    try:
        out = train_dipaco.run(
            preset_name="paper", phases=ALG1_PHASES, tau=ALG1_TAU,
            batch_size=ALG1_BATCH, docs=ALG1_DOCS, ckpt=root, device=DEV12,
            on_phase=keep)
        sync(DEV12)
        res = {"seconds": time.perf_counter() - t0,
               "peak_memory_gib": peak_gib(DEV12), "launches": counts(),
               "shard_sizes_before": out["sizes_before"],
               "shard_sizes_after": out["sizes_after"],
               "phase_losses": [p["mean_loss"] for p in out["phases"]],
               "routed_eval_best": out["eval"]}
        print(f"[alg1] {res} ({card})", flush=True)
        tr, cfg = out["trainer"], out["cfg"]
        assert out["sizes_after"] is not None \
            and min(out["sizes_after"]) > 0, out["sizes_after"]
        assert np.isfinite(out["eval"]["ppl"]), out["eval"]
        res["losses"] = alg1_losses(out, kept)
        res["scoring"] = alg1_scoring(out, kept[out["reshard_phase"]])
        res["early_stopping"] = alg1_early_stopping(out, kept)
        del kept
        res["dumps"] = alg1_dumps(out)
        res["flash_attention_expected"] = cfg.num_layers * alg1_forwards(out)
        if DEV12 == "cuda":
            launched = res["launches"]
            check_launches(cfg, launched,
                           tr.num_workers * ALG1_TAU * ALG1_PHASES,
                           "phase 12 (a)")
            assert launched["flash_attention"] == \
                res["flash_attention_expected"], res
            # kmeans_fit's 25 Lloyd iterations, its final assignment and
            # the validation documents'
            assert launched["router_assign"] == KMEANS_ITERS + 2, launched
        res["rerouted"] = alg1_rerouted(out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in ("trainer", "db", "scores"):
        out.pop(k)
    free_memory()
    return res, out


class MixedGradients:
    """Wraps the sync trainer's step (§4.5): captures the mixed gradient
    AdamW takes for each worker, checks that workers sharing a module
    got the same bits of it (``sharing_mismatch``), and records each
    worker's clip scale (AdamW clips a worker's mixed gradient by its
    own global norm) and the shared modules of the parameters after the
    step."""

    def __init__(self, tr):
        self.tr, self.inner = tr, tr._step_fn
        self.grads, self.params, self.clip_scales = [], [], []

    def __call__(self, *args):
        taken, real = [], launch_steps.adamw_update_

        def capture(grads, state, params, **kw):
            taken.append(grads)
            return real(grads, state, params, **kw)

        launch_steps.adamw_update_ = capture
        try:
            result = self.inner(*args)
        finally:
            launch_steps.adamw_update_ = real
        tr = self.tr
        stacked = pytree.tree_map(lambda *g: torch.stack(g), *taken)
        self.grads.append(sharing_mismatch(stacked, tr.axes, tr.mix_layers,
                                           tr.mix_shared))
        self.params.append(sharing_mismatch(result[0], tr.axes,
                                            tr.mix_layers, tr.mix_shared))
        self.clip_scales.append([min(1.0, 1.0 / float(global_norm(g)))
                                 for g in taken])
        del stacked, taken
        return result


def variant(name: str, dcfg, ds, data, val_assign, *,
            sync_trainer: bool = False) -> dict:
    """One of the paper's variants from (a)'s base weights: 2 phases of
    tau 4, each phase's mean loss finite and falling, the attention
    kernels launched as the steps need, and the invariant of its mixing:
    workers that share a module hold it bit for bit after every outer
    step; for the sync trainer, their mixed gradients are the same bits
    at every inner step (the parameters part where AdamW's clip scales
    differ, in the reference too: tests/test_torch_examples.py)."""
    cfg = data["cfg"]
    reset_counts()
    reset_peak(DEV12)
    kw = dict(base_params=data["base"], batch_size=ALG1_BATCH, peak_lr=2e-3,
              warmup=ALG1_TAU, total_steps=VARIANT_PHASES * ALG1_TAU)
    tr = (SyncDiPaCoTrainer(cfg, dcfg, ds, device=DEV12, **kw)
          if sync_trainer else
          make_trainer(cfg, dcfg, ds, backend="vector", device=DEV12, **kw))
    shared = []
    if sync_trainer:
        mixed = tr._step_fn = MixedGradients(tr)
    phases = []
    for _ in range(VARIANT_PHASES):
        t0 = time.perf_counter()
        m = tr.run_phase()
        sync(DEV12)
        phases.append({"mean_loss": m.mean_loss,
                       "seconds": time.perf_counter() - t0})
        if not sync_trainer:
            shared.append(sharing_mismatch(tr.worker_params, tr.axes,
                                           tr.mix_layers, tr.mix_shared))
    launched = counts()
    ev = tr.evaluate_routed(data["val"], val_assign)
    res = {"shard_sizes": ds.sizes.tolist(), "phases": phases,
           "peak_memory_gib": peak_gib(DEV12), "routed_eval": ev,
           "alg1_routed_eval_best": data["eval"], "launches": launched,
           "sharing": shared, "workers": tr.num_workers,
           "paths": tr.partition.num_paths}
    if sync_trainer:
        shared = mixed.grads
        res.update(sharing=shared, params_sharing=mixed.params,
                   clip_scales=mixed.clip_scales)
        print(f"[variant {name}] shared modules of the parameters after "
              f"each step: {mixed.params}; clip scales {mixed.clip_scales}",
              flush=True)
    print(f"[variant {name}] losses {[p['mean_loss'] for p in phases]}, "
          f"phase seconds {[p['seconds'] for p in phases]}, peak "
          f"{res['peak_memory_gib']} GiB, routed ppl {ev['ppl']:.3f} "
          f"((a), best: {data['eval']['ppl']:.3f}), shards "
          f"{res['shard_sizes']}, shared modules "
          f"{'(mixed gradients) ' if sync_trainer else ''}{shared}",
          flush=True)
    losses = [p["mean_loss"] for p in phases]
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses
    assert np.isfinite(ev["ppl"]), ev
    assert all(s["differ"] == 0 for s in shared), shared
    if DEV12 == "cuda":
        check_launches(cfg, launched,
                       tr.num_workers * ALG1_TAU * VARIANT_PHASES, name)
    del tr, shared
    free_memory()
    return res


def variants12(data) -> dict:
    """(b): the paper's variants on (a)'s documents and base weights,
    each with its own trainer, freed before the next is built."""
    cfg, base, docs, feats = (data[k] for k in ("cfg", "base", "docs",
                                                "feats"))
    val, va, cents = data["val"], data["val_assign"], data["centroids"]
    tau = dict(inner_steps=ALG1_TAU)
    out = {}
    # Table 1: classic DiLoCo, every worker on the one module
    out["diloco"] = variant("diloco", diloco_config(4, **tau),
                            shard_documents(docs, np.arange(len(docs)) % 4,
                                            4), data, np.zeros_like(va))
    assert out["diloco"]["sharing"][0]["pairs"] > 0
    # Tables 1, 2: flat MoE on (a)'s k-means shards (nothing shared)
    out["flat_moe"] = variant("flat_moe", flat_moe_config(4, **tau),
                              data["dataset"], data, va)
    # Table 1: a path-specific second level
    out["path_specific"] = variant(
        "path_specific", DiPaCoConfig(levels=(2, 2), path_specific_levels=(1,),
                                      **tau), data["dataset"], data, va)
    # §4.5: per-step gradient mixing
    out["sync"] = variant("sync", DiPaCoConfig(levels=(2, 2), **tau),
                          data["dataset"], data, va, sync_trainer=True)
    assert len(out["sync"]["sharing"]) == VARIANT_PHASES * ALG1_TAU
    # Table 5: 2x2 on product k-means shards, 2 centroids a half, so
    # router_assign runs at D d_model / 2 and K 2
    vfeats = prefix_features(base, cfg, val)
    reset_counts()
    pair, passign = product_kmeans_fit(
        feats, 2, generator=torch.Generator(device=DEV12).manual_seed(3))
    pva = product_kmeans_assign(vfeats, pair).cpu().numpy()
    launched = counts()
    if DEV12 == "cuda":
        assert launched["router_assign"] == 2 * (KMEANS_ITERS + 1) + 2, \
            launched
    out["product_kmeans"] = variant(
        "product_kmeans", DiPaCoConfig(levels=(2, 2), **tau),
        shard_documents(docs, passign.cpu().numpy(), 4), data, pva)
    out["product_kmeans"]["router_assign_launches"] = \
        launched["router_assign"]
    # §2.4.4, Table 2: flat MoE on top-2 overlapping k-means shards
    out["flat_moe_top2"] = variant(
        "flat_moe_top2", flat_moe_config(4, **tau),
        shard_documents(docs, topn_assign(feats, cents, 2).cpu().numpy(), 4),
        data, va)
    return out


def examples12() -> dict:
    """(c): the other four examples at their scripts' sizes, through
    their functions; each must end cleanly, the two that serve must
    launch flash decode, train_and_serve must swap and roll back, and
    every architecture's loss must fall."""
    runs = {"quickstart": quickstart.run, "serve_paths": serve_paths.run,
            "train_and_serve": functools.partial(train_and_serve.run,
                                                 tmp_dir=SHM12),
            "multiarch_smoke": multiarch_smoke.run}
    out = {}
    for name, fn in runs.items():
        reset_counts()
        reset_peak(DEV12)
        t0 = time.perf_counter()
        r = fn(device=DEV12, **EXAMPLES12[name])
        sync(DEV12)
        out[name] = {"seconds": time.perf_counter() - t0,
                     "peak_memory_gib": peak_gib(DEV12),
                     "launches": counts()}
        if name == "quickstart":
            out[name].update(losses=r["losses"], eval=r["eval"])
            assert np.isfinite(r["losses"]).all(), r["losses"]
            assert np.isfinite(r["eval"]["ppl"]), r["eval"]
        elif name == "serve_paths":
            out[name].update(stats=dataclasses.asdict(r["stats"]),
                             switches=r["rerouted"].switches)
            assert r["stats"].completed == len(r["finished"]), r["stats"]
        elif name == "train_and_serve":
            out[name].update({k: r[k] for k in (
                "by_version", "swaps", "swaps_after_rollback", "latest",
                "rolled_back_to", "versions_after_rollback", "published")})
            assert r["swaps"] >= 1, r["swaps"]
            assert r["rolled_back_to"] < r["latest"], r
            assert r["versions_after_rollback"] == [r["rolled_back_to"]], r
        else:
            out[name].update(losses={a["arch"]: (a["first"], a["last"])
                                     for a in r})
            assert all(a["last"] < a["first"] for a in r), out[name]
        if DEV12 == "cuda" and name in ("serve_paths", "train_and_serve"):
            assert out[name]["launches"]["flash_decode"] > 0, out[name]
        print(f"[example {name}] {out[name]}", flush=True)
        del r
        free_memory()
    return out


def phase12(card: str) -> dict:
    """Phase 12: (a) Algorithm 1 through ``train_dipaco.run``, (b) the
    paper's variants, (c) the other four examples."""
    t_start = time.perf_counter()
    res, data = alg1(card)
    out = {"alg1": res}
    t0 = time.perf_counter()
    out["variants"] = variants12(data)
    out["variants_seconds"] = time.perf_counter() - t0
    del data
    free_memory()
    t0 = time.perf_counter()
    out["examples"] = examples12()
    out["examples_seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_start
    print(f"[examples phase] (a) {res['seconds']:.1f} s, (b) "
          f"{out['variants_seconds']:.1f} s, (c) "
          f"{out['examples_seconds']:.1f} s, {out['seconds']:.1f} s in all",
          flush=True)
    return out


def phase12_launches(kernels: list, out: dict) -> None:
    """Phase 12's launch counts into the kernels line: (a)'s and the
    variants' training kernels, (a)'s forwards and assignments, the
    product k-means' assignments, and the examples' serving, SSD and
    expert kernels."""
    variants = out["variants"].values()
    examples = out["examples"].values()
    for k in kernels:
        name = k["name"]
        if name not in out["alg1"]["launches"]:
            continue
        k["launches_phase12_alg1"] = out["alg1"]["launches"][name]
        k["launches_phase12_variants"] = sum(v["launches"][name]
                                             for v in variants)
        k["launches_phase12_examples"] = sum(e["launches"][name]
                                             for e in examples)
        if name == "router_assign":
            k["launches_phase12_product_kmeans"] = out["variants"][
                "product_kmeans"]["router_assign_launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)

    t0 = time.perf_counter()
    reports = build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{list(build.SOURCES)}")
    # spill bytes of the bf16 backward at head_dim 192 / 256 (the two
    # column chunks of dK/dV at each, and dQ), which must be 0.  A library
    # built before this run has no report: remove build/kernels to read it
    wide_bwd = {}
    for name, log in reports.items():
        entry = ""
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[ptxas {name}] {line.strip()}")
            if "entry function" in line:
                entry = line
            elif "spill stores" in line and WIDE_BWD.search(entry):
                words = line.split()
                wide_bwd[entry] = int(words[4]) + int(words[8])
    assert len(wide_bwd) == 6 and not any(wide_bwd.values()), wide_bwd
    tensor_core_sass()
    decode_smem()

    if "--deploy" in sys.argv[1:]:
        # phase 9 alone, on phase 4's data and weights (development)
        cfg = get_config("dipaco-150m").replace(
            attn_impl="pallas", dtype="bfloat16", route_prefix_len=32)
        _, train_ds, train_base = train(cfg)
        out = deploy(card, cfg, train_ds, train_base, 0.0)
        print(card)
        print(json.dumps(out))
        return 0

    if "--mesh" in sys.argv[1:]:
        # phase 10 alone, on phase 4's data and weights (development)
        cfg = get_config("dipaco-150m").replace(
            attn_impl="pallas", dtype="bfloat16", route_prefix_len=32)
        _, train_ds, train_base = train(cfg)
        out = mesh(card, cfg, train_ds, train_base)
        print(card)
        print(json.dumps(out))
        return 0

    if "--examples" in sys.argv[1:]:
        # phase 12 alone after the build (development)
        out = phase12(card)
        print(card)
        print(json.dumps(out))
        return 0

    if "--service-probe" in sys.argv[1:]:
        cfg = get_config("dipaco-150m").replace(
            attn_impl="pallas", dtype="bfloat16", route_prefix_len=32)
        _, train_ds, train_base = train(cfg)
        out = {"probe": service_probe(cfg, train_ds, train_base),
               "service": service(cfg, train_ds, train_base)}
        # phase 8's barrier against the vector trainer, and its planted
        # faults, at all 12 blocks
        root = Path(tempfile.mkdtemp(prefix="dipaco-probe-"))
        try:
            out["barrier_12_blocks"] = service_phase(cfg, train_ds,
                                                     train_base, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(card)
        print(json.dumps(out))
        return 0

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_s = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    train_attn = training_attention_timings(gen, TRAIN_BATCH, DOC_LEN, 16,
                                            64)
    train_attn[0]["cases"] = check_training_attention(gen)
    kernels = [check_flash_attention(gen), check_flash_decode(gen),
               *train_attn, check_router_assign(gen), check_ssd_scan(gen),
               check_ssd_scan_bwd(gen), check_expert_gemm(gen),
               *check_expert_gemm_bwd(gen)]
    family_kernels = [*check_families_attention(gen),
                      *check_gemm_families(gen), *check_wide_attention(gen),
                      *check_wide_decode(gen), *check_wide_training(gen)]
    phase_s["kernels"] = time.perf_counter() - t0
    print(json.dumps({"phase2_kernels": kernels + family_kernels}),
          flush=True)
    print(f"[phase] kernels: {phase_s['kernels']:.1f} s", flush=True)

    if "--families" in sys.argv[1:]:
        # phase 11 alone after the kernels (development)
        fam = families11()
        family_launches(family_kernels, fam)
        print(json.dumps({"families": fam}))
        print(card)
        print(json.dumps({"kernels": kernels + family_kernels}))
        return 0
    t0 = time.perf_counter()

    cfg = get_config("dipaco-150m").replace(attn_impl="pallas",
                                            dtype="bfloat16")
    runs = serve(cfg)
    # f32: summation order only, over 12 blocks; bf16: one bf16 rounding
    # of each block's attention output, carried through 12 blocks
    parity = {"float32": prefill_decode_parity(cfg, "float32", 1e-3),
              "bfloat16": prefill_decode_parity(cfg, "bfloat16", 0.25)}
    phase_s["serve dipaco-150m"] = time.perf_counter() - t0
    print(f"[phase] serve dipaco-150m: {phase_s['serve dipaco-150m']:.1f} s", flush=True)
    t0 = time.perf_counter()

    trained, train_ds, train_base = train(cfg.replace(route_prefix_len=32))
    trained["remat_cost"] = remat_cost(cfg.replace(route_prefix_len=32))
    grads = {dt: train_grad_parity(cfg, dt) for dt in ("float32", "bfloat16")}
    free_memory()
    phase_s["train dipaco-150m"] = time.perf_counter() - t0
    print(f"[phase] train dipaco-150m: {phase_s['train dipaco-150m']:.1f} s", flush=True)
    t0 = time.perf_counter()
    trained["dryrun"] = dryrun_phase(cfg.replace(route_prefix_len=32),
                                     trained["remat_cost"])
    phase_s["dryrun"] = time.perf_counter() - t0
    print(f"[phase] dryrun: {phase_s['dryrun']:.1f} s", flush=True)

    families = {}
    for name, num_paths, depth, tols, prompt_len, batch, f32_depth in \
            FAMILIES:
        t0 = time.perf_counter()
        fcfg = cut_layers(get_config(name).replace(
            attn_impl="pallas", dtype="bfloat16"), depth)
        fam = {"serve": serve(fcfg, num_paths, PROFILE_PROMPT)}
        fam["parity"] = {dt: prefill_decode_parity(
            fcfg, dt, tol, prompt_len=prompt_len, batch=batch,
            depth=f32_depth if dt == "float32" else None)
            for dt, tol in tols.items()}
        families[name] = fam
        phase_s[f"serve {name}"] = time.perf_counter() - t0
        print(f"[phase] serve {name}: {phase_s[f'serve {name}']:.1f} s")

    for name, dcfg, batch, depth in FAMILY_TRAIN:
        t0 = time.perf_counter()
        families[name]["train"] = train_family(name, dcfg, batch, depth)
        families[name]["train_grad_parity"] = {
            dt: family_grad_parity(name, dt) for dt in ("float32", "bfloat16")}
        phase_s[f"train {name}"] = time.perf_counter() - t0
        print(f"[phase] train {name}: {phase_s[f'train {name}']:.1f} s",
              flush=True)

    mamba, moe = (families[n]["serve"] for n in ("mamba2-1.3b",
                                                  "qwen2-moe-a2.7b"))
    trained_ssm = families["mamba2-1.3b"]["train"]["launches"]
    trained_moe = families["qwen2-moe-a2.7b"]["train"]["launches"]
    for k in kernels:
        if k["name"] in ("flash_attention", "flash_decode"):
            k["launches"] = runs["plain"]["launches"][k["name"]]
            k["launches_reroute"] = runs["reroute"]["launches"][k["name"]]
            k["launches_qwen2_moe"] = moe["plain"]["launches"][k["name"]]
        elif k["name"] == "ssd_scan":
            k["launches"] = mamba["plain"]["launches"]["ssd_scan"]
            k["launches_reroute"] = mamba["reroute"]["launches"]["ssd_scan"]
            k["launches_train"] = trained_ssm["ssd_scan"]
        elif k["name"] == "ssd_scan_bwd":
            k["launches"] = trained_ssm["ssd_scan_bwd"]
        elif k["name"] == "expert_gemm":
            k["launches"] = moe["plain"]["launches"]["expert_gemm"]
            k["launches_reroute"] = moe["reroute"]["launches"]["expert_gemm"]
            k["launches_train"] = trained_moe["expert_gemm"]
        elif k["name"] in ("expert_gemm_dx", "expert_gemm_dw"):
            k["launches"] = trained_moe[k["name"]]
        else:
            k["launches"] = trained["launches"][k["name"]]
    kernels[0]["launches_train"] = trained["launches"]["flash_attention"]
    for k in kernels:
        if k["name"] in ("flash_attention_lse", "flash_attention_dkv",
                         "flash_attention_dq"):
            k["launches_train_qwen2_moe"] = trained_moe[k["name"]]
    t0 = time.perf_counter()
    reset_counts()
    cont = continuous(card)
    phase_s["continuous"] = time.perf_counter() - t0
    print(f"[phase] continuous: {phase_s['continuous']:.1f} s", flush=True)
    t0 = time.perf_counter()
    svc = service(cfg.replace(route_prefix_len=32), train_ds, train_base)
    phase_s["service"] = time.perf_counter() - t0
    print(f"[phase] service: {phase_s['service']:.1f} s", flush=True)
    t0 = time.perf_counter()
    reset_counts()
    dep = deploy(card, cfg.replace(route_prefix_len=32), train_ds, train_base,
                 svc["file_gb"])
    phase_s["deploy"] = time.perf_counter() - t0
    print(f"[phase] deploy: {phase_s['deploy']:.1f} s", flush=True)
    t0 = time.perf_counter()
    meshed = mesh(card, cfg.replace(route_prefix_len=32), train_ds, train_base)
    del train_base, train_ds
    free_memory()
    phase_s["mesh"] = time.perf_counter() - t0
    print(f"[phase] mesh: {phase_s['mesh']:.1f} s", flush=True)
    t0 = time.perf_counter()
    fam = families11()
    family_launches(family_kernels, fam)
    phase_s["families"] = time.perf_counter() - t0
    print(f"[phase] families: {phase_s['families']:.1f} s", flush=True)
    t0 = time.perf_counter()
    examples = phase12(card)
    phase12_launches(kernels, examples)
    phase_s["examples"] = time.perf_counter() - t0
    print(f"[phase] examples: {phase_s['examples']:.1f} s", flush=True)
    for k in kernels:
        if k["name"] in ("flash_attention_lse", "flash_attention_dkv",
                         "flash_attention_dq"):
            k["launches_barrier"] = svc["barrier"]["launches"][k["name"]]
            k["launches_service"] = svc["service"]["launches"][k["name"]]
        elif k["name"] == "router_assign":
            k["launches_rerouted"] = trained["rerouted_eval"]["launches"][
                "router_assign"]
    for k in kernels:
        if k["name"] == "flash_decode":
            k["launches_continuous"] = cont["eager"]["launches"][
                "flash_decode"]
            k["launches_continuous_graph"] = cont["graph"]["launches"][
                "flash_decode"]
            k["replayed_per_graph_tick"] = cont["graph"]["graph"][
                "decode_kernels_per_replay"]
        elif k["name"] == "flash_attention":
            k["launches_continuous_router"] = cont["router"]["launches"][
                "flash_attention"]
        elif k["name"] == "ssd_scan":
            k["launches_continuous_mamba"] = cont["mamba"]["stacked"][
                "launches"]["ssd_scan"]
    for k in kernels:
        if k["name"] in ("flash_attention", "flash_decode"):
            k["launches_deploy"] = dep["swaps"]["launches"][k["name"]]
            k["launches_deploy_training"] = dep["training"]["launches"][
                k["name"]]
        elif k["name"] in ("flash_attention_lse", "flash_attention_dkv",
                           "flash_attention_dq"):
            k["launches_deploy_training"] = dep["training"]["launches"][
                k["name"]]
            k["launches_mesh"] = meshed["one"]["launches"][k["name"]]
    print(f"[phase] seconds: {phase_s}")

    summary = {"kernels": kernels + family_kernels}
    print(json.dumps({"serve": runs, "prefill_decode_parity": parity,
                      "train": trained, "train_grad_parity": grads,
                      "families": families, "continuous": cont,
                      "service": svc, "deploy": dep, "mesh": meshed,
                      "families11": fam, "examples": examples,
                      "phase_seconds": phase_s}))
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
