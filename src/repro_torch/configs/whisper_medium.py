"""whisper-medium [audio]: encoder-decoder; conv frontend is a STUB.

24L enc + 24L dec, d_model=1024 16H (MHA) d_ff=4096 vocab=51865 (padded to
51968). input_specs() supplies precomputed mel-frame embeddings
(B, 1500, d_model). Decode shapes exercise the DECODER with the fixed
1500-frame encoder stub. [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,  # decoder layers
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51_865,
        pattern=("global",),
        activation="gelu_plain",
        encdec=EncDecConfig(num_encoder_layers=24, encoder_frames=1500),
        tie_embeddings=True,
        notes="enc-dec; decoder cross-attends the 1500-frame encoder stub.",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=("global",),
        activation="gelu_plain",
        encdec=EncDecConfig(num_encoder_layers=2, encoder_frames=30),
    )


register("whisper-medium", full, smoke)
