"""Qwen3-MoE-235B-A22B [moe] — 94L d4096 64H (GQA kv=4) moe_d_ff=1536
vocab=151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family]"""
from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        arch_type="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        mlp_type="swiglu",
        pattern=(BlockSpec("attn", "moe"),),
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=128, vocab_size=512, dtype="float32", remat=False,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )
