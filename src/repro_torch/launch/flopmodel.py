"""Analytic FLOP / HBM-byte model for the roofline (per arch x shape);
the port's copy of ``repro/launch/flopmodel.py``, the same arithmetic
on the port's own ``ModelConfig`` and ``InputShape``.

The count does not depend on which kernels run the step: the dry-run
records it beside the FLOPs that ``torch.utils.flop_counter`` counts
through the plain versions on the meta device (``launch/dryrun.py``).

All formulas are per-token (then multiplied by token count and a
fwd/bwd/remat multiplier), matching the standard 6ND accounting when
attention/dispatch terms are small.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.models.config import InputShape, ModelConfig


def _bytes_of(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[dtype]


# ---------------------------------------------------------------------------
# per-token forward FLOPs by component
# ---------------------------------------------------------------------------
def attn_flops_per_token(cfg: ModelConfig, s_kv: float) -> float:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * d * (h + 2 * kh) * hd + 2 * h * hd * d
    scores = 2 * s_kv * h * hd * 2          # QK^T and PV
    return proj + scores


def mlp_flops_per_token(cfg: ModelConfig, d_ff: int) -> float:
    nmat = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return 2 * nmat * cfg.d_model * d_ff


def moe_flops_per_token(cfg: ModelConfig, tokens_per_group: float) -> float:
    m = cfg.moe
    d = cfg.d_model
    router = 2 * d * m.num_experts
    nmat = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    expert = 2 * nmat * d * m.d_ff_expert * m.top_k
    if m.impl == "dense":
        # GShard dispatch+combine einsums: 2 x (2 * E*C * d) per token,
        # E*C = g*k*cf
        ec = tokens_per_group * m.top_k * m.capacity_factor
        dispatch = 2 * 2 * ec * d
        expert = expert * m.capacity_factor  # padded capacity buckets
    else:
        dispatch = 0.0                       # scatter: memory traffic only
        expert = expert * m.capacity_factor
    shared = 0.0
    if m.num_shared:
        shared = 2 * nmat * d * (m.d_ff_shared or
                                 m.num_shared * m.d_ff_expert)
    return router + dispatch + expert + shared


def ssm_flops_per_token(cfg: ModelConfig) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    h = d_inner // s.head_dim
    n, p, c = s.d_state, s.head_dim, s.chunk
    gn = s.n_groups * n
    proj_out = 2 * d_inner + 2 * gn + h
    in_proj = 2 * d * proj_out
    conv = 2 * s.conv_width * (d_inner + 2 * gn)
    # SSD per token: CB^T (2*c*h*n) + mask-weighted X (2*c*h*p)
    #              + states (2*h*n*p) + y_off (2*h*n*p) + inter-chunk decay
    ssd = 2 * c * h * n + 2 * c * h * p + 4 * h * n * p
    out_proj = 2 * d_inner * d
    gate = 4 * d_inner
    return in_proj + conv + ssd + out_proj + gate


def block_flops_per_token(cfg: ModelConfig, spec, s_kv: float,
                          tokens_per_group: float) -> float:
    f = 0.0
    if spec.mixer == "attn":
        f += attn_flops_per_token(cfg, s_kv)
    else:
        f += ssm_flops_per_token(cfg)
    if spec.mlp == "dense":
        f += mlp_flops_per_token(cfg, cfg.d_ff)
    elif spec.mlp == "moe":
        f += moe_flops_per_token(cfg, tokens_per_group)
    return f


@dataclass
class FlopReport:
    fwd_flops: float          # whole-step forward FLOPs (all tokens, all chips)
    total_flops: float        # incl. bwd + remat multiplier
    hbm_bytes: float          # modelled HBM traffic (all chips)
    breakdown: dict


def analyze(cfg: ModelConfig, shape: InputShape, *,
            num_workers: int = 1) -> FlopReport:
    dt = _bytes_of(cfg.dtype)
    if shape.kind == "decode":
        tokens = shape.global_batch            # 1 new token per request
        s_kv = float(shape.window or shape.seq_len)
        causal_frac = 1.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        s_kv = _avg_skv(cfg, shape)
        causal_frac = 1.0
    else:
        tokens = shape.global_batch * shape.seq_len
        s_kv = _avg_skv(cfg, shape)
        causal_frac = 1.0
    tokens_per_group = min(1024.0, float(tokens / max(num_workers, 1)))

    reps = cfg.pattern_repeats
    per_tok = 0.0
    bd = {"attn": 0.0, "mlp": 0.0, "moe": 0.0, "ssm": 0.0}
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            bd["attn"] += attn_flops_per_token(cfg, s_kv) * reps
        else:
            bd["ssm"] += ssm_flops_per_token(cfg) * reps
        if spec.mlp == "dense":
            bd["mlp"] += mlp_flops_per_token(cfg, cfg.d_ff) * reps
        elif spec.mlp == "moe":
            bd["moe"] += moe_flops_per_token(cfg, tokens_per_group) * reps
    per_tok = sum(bd.values())
    unembed = 2 * cfg.d_model * cfg.vocab_size
    bd["unembed"] = unembed
    per_tok += unembed
    if cfg.encoder is not None:
        if shape.kind == "decode" and cfg.cross_kv_cache:
            # encoder fwd + cross K/V projections happen once at prefill;
            # per decode step only q/o proj + scores remain
            cross = (2 * cfg.d_model * 2 * cfg.num_heads * cfg.head_dim
                     + 2 * cfg.encoder.source_len * cfg.num_heads
                     * cfg.head_dim * 2) * cfg.num_layers
            enc_per_tok = 0.0
        else:
            # honest recompute: full enc fwd amortized per token + cross
            # K/V recomputed every step
            enc_tok_per_tok = cfg.encoder.source_len / max(
                1 if shape.kind == "decode" else shape.seq_len, 1)
            enc_per_tok = (attn_flops_per_token(cfg, cfg.encoder.source_len)
                           + mlp_flops_per_token(cfg, cfg.d_ff)) \
                * cfg.encoder.num_layers * enc_tok_per_tok
            cross = (2 * cfg.d_model * 3 * cfg.num_kv_heads * cfg.head_dim
                     + 2 * cfg.encoder.source_len * cfg.num_heads
                     * cfg.head_dim * 2) * cfg.num_layers
            if shape.kind == "decode":
                cross += (2 * cfg.d_model * 2 * cfg.encoder.source_len
                          * cfg.num_kv_heads * cfg.head_dim
                          * cfg.num_layers)  # K/V recompute vs 1500 frames
        bd["encdec_extra"] = enc_per_tok + cross
        per_tok += enc_per_tok + cross

    fwd = per_tok * tokens
    if shape.kind == "train":
        if not cfg.remat:
            mult = 3.0                       # fwd + 2x bwd
        elif cfg.remat_policy == "dots":
            mult = 3.4                       # matmul outputs saved; only
            #                                  elementwise recompute (~0.4)
        else:
            mult = 4.0                       # full recompute remat
    else:
        mult = 1.0
    total = fwd * mult

    hbm = _bytes_model(cfg, shape, tokens, s_kv, num_workers, dt)
    return FlopReport(fwd_flops=fwd, total_flops=total, hbm_bytes=hbm,
                      breakdown=bd)


def _avg_skv(cfg: ModelConfig, shape: InputShape) -> float:
    S = shape.seq_len
    w = cfg.sliding_window
    if w and w < S:
        return float(w)                      # windowed: ~w keys per query
    if cfg.causal_skip:
        return S / 2.0                       # triangular chunks only
    if cfg.attn_impl == "chunked":
        return float(S)                      # baseline computes masked full
    return S / 2.0 if False else float(S)


def param_count(cfg: ModelConfig) -> tuple:
    from .specs import active_param_count
    return active_param_count(cfg)


def _bytes_model(cfg: ModelConfig, shape: InputShape, tokens: int,
                 s_kv: float, num_workers: int, dt: int) -> float:
    total_p, active_p = param_count(cfg)
    W = max(num_workers, 1)
    if shape.kind == "train":
        # per worker per step: params fwd read + bwd read (+ remat read)
        # + write, AdamW m/v read+write (f32), grads materialized f32
        reads = 4 if cfg.remat else 3
        param_traffic = W * total_p * (reads * dt + 16 + 8)
        act = _act_bytes(cfg, tokens, s_kv, dt) * (3 if cfg.remat else 2)
        return param_traffic + act
    if shape.kind == "prefill":
        return W * total_p * dt + _act_bytes(cfg, tokens, s_kv, dt)
    # decode: every request reads active params once + its KV cache
    param_traffic = W * active_p * dt
    cache = _cache_bytes(cfg, shape, dt) * 1.0
    return param_traffic + cache


def _act_bytes(cfg: ModelConfig, tokens: int, s_kv: float, dt: int) -> float:
    d = cfg.d_model
    per_layer_tok = 12 * d * dt              # residual stream traffic
    if any(s.mixer == "attn" for s in cfg.pattern):
        # chunked attention re-reads K/V once per q-chunk
        nq = max(1.0, s_kv / cfg.attn_chunk_q / 2)
        per_layer_tok += 2 * cfg.num_kv_heads * cfg.head_dim * dt * nq
    logits = 2 * cfg.vocab_size * dt / 4     # fused logsumexp estimate
    return tokens * (per_layer_tok * cfg.num_layers + logits)


def _cache_bytes(cfg: ModelConfig, shape: InputShape, dt: int) -> float:
    B = shape.global_batch
    L = shape.window or shape.seq_len
    total = 0.0
    reps = cfg.pattern_repeats
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            # int8 KV cache: 1 byte/elem + f32 scale per (token, head)
            kv_bytes = (1.0 + 4.0 / cfg.head_dim) if cfg.kv_quant else dt
            total += (2 * B * L * cfg.num_kv_heads * cfg.head_dim
                      * kv_bytes * reps)
        else:
            s = cfg.ssm
            d_inner = s.expand * cfg.d_model
            h = d_inner // s.head_dim
            total += B * h * s.head_dim * s.d_state * 4 * reps * 2
    if cfg.encoder is not None:
        total += 2 * B * L * cfg.num_kv_heads * cfg.head_dim * dt \
            * cfg.num_layers
        total += B * cfg.encoder.source_len * cfg.d_model * dt
    return total
