"""Moonshot/Moonlight-16B-A3B — 48L d2048 16H (kv=16) expert_d_ff=1408
vocab=163840, MoE 64e top-6 (+2 shared per the Moonlight card).
Assignment labels it [dense] but specifies MoE fields; we implement the
MoE per the fields (see DESIGN.md §4).  [hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        arch_type="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        mlp_type="swiglu",
        pattern=(BlockSpec("attn", "moe"),),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared=2, d_ff_shared=2816),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=128, vocab_size=512, dtype="float32", remat=False,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      num_shared=1, d_ff_shared=128),
    )
