"""falcon-mamba-7b [ssm]: Mamba-1 architecture, attention-free.

64L d_model=4096, d_state=16, d_conv=4, expand=2 (d_inner 8192),
vocab=65024. long_500k applicable (O(1) state decode).
[arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=1,  # unused (attention-free)
        num_kv_heads=1,
        head_dim=1,
        d_ff=0,  # Mamba block subsumes the MLP
        vocab_size=65_024,
        pattern=("ssm",),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        family="ssm",
        num_layers=4,
        d_model=64,
        num_heads=1,
        num_kv_heads=1,
        head_dim=1,
        d_ff=0,
        vocab_size=512,
        pattern=("ssm",),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    )


register("falcon-mamba-7b", full, smoke)
