"""internvl2-26b [vlm]: InternLM2-20B backbone; InternViT frontend is a STUB.

48L d_model=6144 48H (GQA kv=8) head_dim=128 d_ff=16384 vocab=92553 (padded).
input_specs() supplies precomputed patch embeddings (B, 256, d_model) that
are prepended to the token embeddings. [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92_553,
        pattern=("global",),
        vision=VisionStubConfig(num_patches=256),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke",
        family="vlm",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=("global",),
        vision=VisionStubConfig(num_patches=8),
        tie_embeddings=False,
    )


register("internvl2-26b", full, smoke)
