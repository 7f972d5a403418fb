"""qwen2-moe-a2.7b [moe]: 60 routed top-4 + shared expert (ff 5632).

24L d_model=2048 16H (MHA kv=16) expert_ff=1408 vocab=151936, QKV bias.
60 experts pad to 64 for EP divisibility (dummy experts: zero weights,
never routed). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=5632,
        vocab_size=151_936,
        pattern=("global",),
        qkv_bias=True,
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            expert_ff=1408,
            shared_ff=5632,  # HF: one shared expert of 4x1408
        ),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=("global",),
        qkv_bias=True,
        moe=MoEConfig(num_experts=6, top_k=2, expert_ff=32, shared_ff=128),
        tie_embeddings=False,
    )


register("qwen2-moe-a2.7b", full, smoke)
