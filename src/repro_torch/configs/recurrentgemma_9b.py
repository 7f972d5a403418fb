"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048,
head_dim 256, GeGLU. [arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        pattern=("recurrent", "recurrent", "local"),
        window_size=2048,
        activation="gelu",
        rglru=RGLRUConfig(lru_width=4096, conv_width=4),
        scale_embed=True,
        tie_embeddings=True,
        notes="Griffin 1:2 attn:recurrent; long_500k applicable (sub-quadratic).",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=("recurrent", "recurrent", "local"),
        window_size=32,
        activation="gelu",
        rglru=RGLRUConfig(lru_width=64, conv_width=4),
    )


register("recurrentgemma-9b", full, smoke)
