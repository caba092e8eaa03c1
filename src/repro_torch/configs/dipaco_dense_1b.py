"""DiPaCo paper dense baseline (Table 4): 24 blocks, d=2048, 16 heads,
key/value size 128, vocab 32000."""
from repro_torch.models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dipaco-dense-1b",
        arch_type="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=32000,
        mlp_type="gelu",
        pattern=(BlockSpec("attn", "dense"),),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=512, dtype="float32", remat=False,
    )
