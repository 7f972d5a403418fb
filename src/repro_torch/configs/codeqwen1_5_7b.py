"""codeqwen1.5-7b [dense]: qwen1.5 arch, MHA, QKV bias.

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416. [hf:Qwen/CodeQwen1.5-7B]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92_416,
        pattern=("global",),
        qkv_bias=True,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        pattern=("global",),
        qkv_bias=True,
        tie_embeddings=False,
    )


register("codeqwen1.5-7b", full, smoke)
