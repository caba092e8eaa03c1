"""Gemma-2B [dense] — 18L d2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256.  [arXiv:2403.08295]"""
from repro_torch.models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        arch_type="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        mlp_type="geglu",
        pattern=(BlockSpec("attn", "dense"),),
        embed_scale=True,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=1, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32", remat=False,
    )
