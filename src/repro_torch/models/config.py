"""Model / DiPaCo / input-shape configuration dataclasses.

The port's own copy of ``repro/models/config.py``, field for field:
``dataclasses.asdict`` of a port config equals the reference's."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0            # always-active shared experts
    d_ff_shared: int = 0           # total shared-expert hidden size
    capacity_factor: float = 1.25
    impl: str = "dense"            # "dense" (GShard one-hot) | "scatter" (sorted buckets)
    router_aux_weight: float = 0.01  # load-balance auxiliary loss


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128               # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class BlockSpec:
    """One layer's composition: a token mixer plus a channel mixer."""
    mixer: str                     # "attn" | "mamba"
    mlp: str                       # "dense" | "moe" | "none"


@dataclass(frozen=True)
class EncoderConfig:
    """Frontend-stub encoder (whisper) — the transformer encoder we DO build."""
    num_layers: int
    num_heads: int
    d_source: int                  # stub frame/patch embedding dim fed by input_specs()
    source_len: int                # number of frames/patches


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM patch-embedding stub: input_specs() provides patch embeddings."""
    num_patches: int
    d_patch: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"       # swiglu | geglu | relu2 | gelu
    pattern: tuple = (BlockSpec("attn", "dense"),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # if set, attention is windowed
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma-style sqrt(d_model) embedding scaling
    logit_softcap: Optional[float] = None
    dtype: str = "bfloat16"        # compute/param dtype for the dry-run
    remat: bool = True             # activation checkpointing per layer group
    remat_policy: str = "full"     # "full" (save nothing) | "dots" (save matmuls)
    island_parallelism: str = "tensor"  # "tensor" | "data" (within an island)
    cross_kv_cache: bool = False   # enc-dec decode: precompute cross K/V
    kv_quant: bool = False         # int8 KV cache (per-token-head scales)
    attn_impl: str = "chunked"     # "chunked" (online-softmax XLA) | "full" | "pallas"
    attn_chunk_q: int = 512
    attn_chunk_k: int = 512
    causal_skip: bool = False      # structurally skip fully-masked causal chunks
    route_prefix_len: int = 32     # DiPaCo routing prefix (excluded from loss)

    @property
    def pattern_repeats(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.pattern)}")
        return self.num_layers // len(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"
    window: Optional[int] = None   # decode window for long-context shapes


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode", window=4096),
}


@dataclass(frozen=True)
class DiPaCoConfig:
    """Paper §2: path-composition + DiLoCo training configuration."""
    levels: tuple = (2, 2)               # K_l per level -> P = prod(K_l)
    level_boundaries: tuple = ()         # layer index cut points; () = equal split
    path_specific_levels: tuple = ()     # level idx whose modules are per-path (§2.6.1)
    shared_embeddings: bool = True       # embedding/unembed shared across all paths
    inner_steps: int = 150               # tau
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    outer_nesterov: bool = True
    grad_norm_rescale: bool = True       # sqrt(P_le) rescaling (§2.7)
    loss_reweigh: bool = True            # shard-size weighting (Eq. 2-3)
    overlap_topn: int = 1                # overlapping shards at train time (§2.4.4)
    router: str = "discriminative"       # kmeans | product_kmeans | discriminative
    router_data_frac: float = 0.005
    eval_route_every: int = 0            # 0 = once per sequence (§2.4.3)
    early_stopping: bool = False
    # async outer updates (paper §3.3 -> Liu et al. 2024): apply a
    # module's outer update once this fraction of its contributors has
    # reported; stragglers fold into the next accumulation window.
    async_quorum: float = 1.0
    # streaming fragment-wise outer sync (Streaming DiLoCo, Douillard
    # et al. 2025): partition each module's parameter tree into
    # ``outer_fragments`` fragments, each with its own accumulation
    # window and Nesterov state.  ``fragment_stagger`` > 0 staggers the
    # fragments' sync instants across the phase (fragment f is sent at
    # slot (f * stagger) mod K; slot 0 = the phase boundary, later
    # slots are in flight while the reporting shard already runs its
    # next phase), flattening the phase-boundary bandwidth burst.
    # ``comm_dtype`` quantizes the outer-gradient wire payload
    # ("fp32" | "int8" | "int4", symmetric per-leaf scales) with an
    # error-feedback residual kept worker-side.  The defaults
    # (1, 0, "fp32") are bit-identical to unfragmented DiLoCo.
    outer_fragments: int = 1
    fragment_stagger: int = 0
    comm_dtype: str = "fp32"
    # delta transport backend (infra/transport.py): "inproc" hands the
    # dequantized wire tree straight to the executors (simulated byte
    # accounting only); "mesh" ships the *encoded* payload across a
    # device boundary and decodes on the executors' device —
    # bit-identical fold values, real measured bytes.
    transport: str = "inproc"
    # heterogeneous-fleet comm policy (core/fragments.py): "uniform"
    # quantizes every leaf at ``comm_dtype`` (the bit-identical legacy
    # path); "leafwise" keeps norms/embeddings fp32, drops large matmul
    # leaves to int4 and ships the rest at ``comm_dtype``
    # (``leaf_comm_dtypes``).
    comm_dtype_policy: str = "uniform"
    # transport chaos hardening (infra/transport.py): ``transport_retries``
    # > 0 (or a ``transport_faults`` spec) wraps the backend in a
    # RetryingTransport — exponential backoff, crc32 checksum rejection
    # of corrupted deliveries, typed TransportError on exhaustion.
    # ``transport_faults`` is a FaultInjector kwargs mapping
    # ({"seed": 0, "drop": 0.1, "dup": 0.05, ...}), deterministic and
    # replayable per seed.
    transport_retries: int = 0
    transport_faults: dict | None = None

    @property
    def num_paths(self) -> int:
        p = 1
        for k in self.levels:
            p *= k
        return p
