"""Qwen3-8B [dense] — 36L d4096 32H (GQA kv=8) d_ff=12288 vocab=151936;
qk_norm, GQA.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        arch_type="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        mlp_type="swiglu",
        pattern=(BlockSpec("attn", "dense"),),
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32", remat=False,
    )
