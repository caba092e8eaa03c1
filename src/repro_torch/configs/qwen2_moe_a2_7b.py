"""Qwen2-MoE-A2.7B [moe] — 24L d2048 16H (kv=16) expert_d_ff=1408
vocab=151936, 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        arch_type="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        mlp_type="swiglu",
        pattern=(BlockSpec("attn", "moe"),),
        moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                      num_shared=4, d_ff_shared=5632),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=128, vocab_size=512, dtype="float32", remat=False,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      num_shared=2, d_ff_shared=256),
    )
