"""qwen2.5-14b [dense]: GQA with QKV bias, SwiGLU.

48L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff=13824 vocab=152064.
40 heads are not divisible by the 16-way model axis; attention falls back
to context-parallel sharding (sharding/rules.py). [hf:Qwen/Qwen2.5; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152_064,
        pattern=("global",),
        qkv_bias=True,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke",
        family="dense",
        num_layers=3,
        d_model=80,
        num_heads=5,  # preserves the non-divisible-heads property
        num_kv_heads=1,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        pattern=("global",),
        qkv_bias=True,
        tie_embeddings=False,
    )


register("qwen2.5-14b", full, smoke)
