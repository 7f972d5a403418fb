"""gemma2-9b [dense]: local(4096)+global alternating, logit softcaps, GeGLU.

42L d_model=3584 16H (GQA kv=8) head_dim=256 d_ff=14336 vocab=256000,
attn softcap 50, final softcap 30, sandwich norms. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        pattern=("local", "global"),
        window_size=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        activation="gelu",
        post_norm=True,
        scale_embed=True,
        tie_embeddings=True,
        notes="long_500k skipped: half the layers are full global attention.",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke",
        family="dense",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=("local", "global"),
        window_size=16,
        attn_softcap=50.0,
        final_softcap=30.0,
        activation="gelu",
        post_norm=True,
    )


register("gemma2-9b", full, smoke)
