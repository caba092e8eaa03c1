"""DiPaCo paper path model (Table 4): 12 blocks, d=896, 16 heads,
key/value size 64, vocab 32000 (SentencePiece in the paper; synthetic
corpus here)."""
from repro_torch.models.config import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dipaco-150m",
        arch_type="dense",
        num_layers=12,
        d_model=896,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=3584,
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
