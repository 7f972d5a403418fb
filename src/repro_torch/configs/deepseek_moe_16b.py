"""deepseek-moe-16b [moe]: 2 shared + 64 routed top-6, fine-grained experts.

28L d_model=2048 16H (MHA kv=16) expert_ff=1408 vocab=102400; layer 0 is a
dense MLP (ff 10944). [arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=10944,  # dense-layer ff (layer 0)
        vocab_size=102_400,
        pattern=("global",),
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            expert_ff=1408,
            shared_ff=2 * 1408,  # 2 shared experts
            first_dense_layers=1,
            first_dense_ff=10944,
        ),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        pattern=("global",),
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            expert_ff=32,
            shared_ff=64,
            first_dense_layers=1,
            first_dense_ff=160,
        ),
        tie_embeddings=False,
    )


register("deepseek-moe-16b", full, smoke)
