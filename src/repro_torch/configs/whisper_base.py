"""Whisper-base [audio] — 6L enc + 6L dec, d512 8H (kv=8) d_ff=2048
vocab=51865; enc-dec, conv/mel frontend STUBBED (input_specs provides
frame embeddings).  [arXiv:2212.04356]"""
from repro_torch.models.config import BlockSpec, EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        arch_type="audio",
        num_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        mlp_type="gelu",
        pattern=(BlockSpec("attn", "dense"),),
        encoder=EncoderConfig(num_layers=6, num_heads=8, d_source=512,
                              source_len=1500),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, dtype="float32", remat=False,
        encoder=EncoderConfig(num_layers=2, num_heads=4, d_source=80,
                              source_len=64),
    )
