"""Pixtral-12B [vlm] — 40L d5120 32H (GQA kv=8) d_ff=14336 vocab=131072;
Pixtral-ViT STUBBED (input_specs provides patch embeddings), Mistral-Nemo
style decoder.  [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.models.config import (BlockSpec, ModelConfig,
                                       VisionStubConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        arch_type="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        mlp_type="swiglu",
        pattern=(BlockSpec("attn", "dense"),),
        vision=VisionStubConfig(num_patches=1024, d_patch=1024),
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32", remat=False,
        vision=VisionStubConfig(num_patches=16, d_patch=64),
    )
