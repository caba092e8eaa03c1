"""Mamba2-1.3B [ssm] — 48L d2048 attn-free, ssm_state=128, SSD
(state-space duality).  [arXiv:2405.21060]"""
from repro_torch.models.config import BlockSpec, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        arch_type="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=1,          # unused (attn-free)
        num_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        pattern=(BlockSpec("mamba", "none"),),
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, vocab_size=512, dtype="float32",
        remat=False,
        ssm=SSMConfig(d_state=32, head_dim=32, expand=2, chunk=64),
    )
