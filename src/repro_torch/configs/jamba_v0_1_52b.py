"""Jamba-v0.1-52B [hybrid] — 32L d4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2; Mamba:attn 7:1 interleave, MoE every other
layer.  [arXiv:2403.19887]

TPU adaptation note (DESIGN.md §3): Jamba's Mamba-1 (d_state=16 selective
scan) is implemented as Mamba2/SSD with d_state=64 — the chunked SSD dual
form maps onto the MXU, whereas the Mamba-1 elementwise scan does not.
"""
from repro_torch.models.config import (BlockSpec, ModelConfig, MoEConfig,
                                       SSMConfig)

# period-8 Jamba block: attention at position 4, Mamba elsewhere;
# MoE on odd positions, dense MLP on even.
_PATTERN = tuple(
    BlockSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        mlp_type="swiglu",
        pattern=_PATTERN,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32", remat=False,
        pattern=(BlockSpec("mamba", "moe"), BlockSpec("attn", "dense")),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        ssm=SSMConfig(d_state=32, head_dim=32, expand=2, chunk=64),
    )
