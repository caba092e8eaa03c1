"""Nemotron-4-340B [dense] — 96L d18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP.  [arXiv:2402.16819]"""
from repro_torch.models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        arch_type="dense",
        num_layers=96,
        d_model=18432,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab_size=256000,
        mlp_type="relu2",
        pattern=(BlockSpec("attn", "dense"),),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=384, num_heads=6, num_kv_heads=2, head_dim=64,
        d_ff=768, vocab_size=512, dtype="float32", remat=False,
    )
