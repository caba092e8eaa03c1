"""The yardstick's arithmetic: peaks of the card, the operations the
model's steps need, and the least time an attention call can take.

``forward_flops_per_token`` is a frozen copy of the dense-attention,
dense-MLP terms of ``repro_torch.launch.flopmodel`` (``attn_flops_per_
token``, ``mlp_flops_per_token`` and the unembedding); with ``s_kv`` the
full sequence it gives ``analyze(...).fwd_flops`` per token, which the
tests check.  The shares of the peak take ``s_kv`` as the mean causal
context, since a causal token attends to the keys up to its own.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def attn_flops_per_token(m: dict, s_kv: float) -> float:
    d, h, kh, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    proj = 2 * d * (h + 2 * kh) * hd + 2 * h * hd * d
    scores = 2 * s_kv * h * hd * 2          # QK^T and PV
    return proj + scores


def mlp_flops_per_token(m: dict) -> float:
    nmat = 3 if m["mlp_type"] in ("swiglu", "geglu") else 2
    return 2 * nmat * m["d_model"] * m["d_ff"]


def forward_flops_per_token(m: dict, s_kv: float) -> float:
    """Forward FLOPs of one token that attends to ``s_kv`` keys."""
    block = attn_flops_per_token(m, s_kv) + mlp_flops_per_token(m)
    return block * m["num_layers"] + 2 * m["d_model"] * m["vocab_size"]


def causal_context(s: int) -> float:
    """Mean number of keys a token of a causal sequence of ``s`` attends
    to."""
    return (s + 1) / 2.0


def train_flops(m: dict, tokens: int, seq_len: int) -> float:
    """Forward and backward (3x the forward; remat's recompute not
    counted) of ``tokens`` training tokens in sequences of ``seq_len``."""
    return 3.0 * tokens * forward_flops_per_token(m, causal_context(seq_len))


def serve_flops(m: dict, tokens: float, context_tokens: float) -> float:
    """Forward FLOPs of serving ``tokens`` tokens (prompt tokens
    prefilled, tokens decoded), whose attended keys sum to
    ``context_tokens`` (each token counts the keys up to its own)."""
    no_attn = forward_flops_per_token(m, 0.0)
    per_key = 4 * m["num_heads"] * m["head_dim"] * m["num_layers"]
    return tokens * no_attn + context_tokens * per_key


def causal_pairs(s: int) -> int:
    """(query, key) pairs of one causal sequence of ``s``."""
    return s * (s + 1) // 2


def attention_fwd_bound_s(b: int, s: int, h: int, kh: int, d: int,
                          elem: int = 2) -> float:
    """Least time of the causal forward that also writes the LSE rows:
    QK^T and PV over the causal pairs, or reading q, k, v and writing o
    and the f32 LSE once, whichever is longer."""
    flops = 4.0 * b * h * causal_pairs(s) * d
    nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * elem + 4 * b * h * s
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def attention_bwd_bound_s(b: int, s: int, h: int, kh: int, d: int,
                          elem: int = 2) -> float:
    """Least time of the causal backward (dQ, dK, dV from q, k, v, o, the
    LSE rows and dO): the scores QK^T, dP = dO V^T, dV = P^T dO, dQ = dS K
    and dK = dS^T Q over the causal pairs, or reading q, k, v, o, dO and
    the LSE and writing dQ, dK, dV once, whichever is longer."""
    flops = 10.0 * b * h * causal_pairs(s) * d
    nbytes = ((3 * b * s * h * d + 2 * b * s * kh * d)      # q, o, dO; k, v
              + (b * s * h * d + 2 * b * s * kh * d)) * elem  # dQ; dK, dV
    nbytes += 4 * b * h * s
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
