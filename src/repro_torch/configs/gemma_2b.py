"""gemma-2b [dense]: MQA (kv=1), GeGLU, head_dim 256.

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000. [arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256_000,
        pattern=("global",),
        activation="gelu",
        scale_embed=True,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        pattern=("global",),
        activation="gelu",
    )


register("gemma-2b", full, smoke)
