"""Config system: model configs, input shapes, and the arch registry.

The port's own copy of the JAX package's ``repro.configs.base``: the same
dataclasses, fields, defaults and derived counts, so that ``get_config``
answers field for field as the reference does.

Every assigned architecture is a frozen :class:`ModelConfig` in its own
``configs/<arch>.py`` file, registered under its public id so launchers can
select it with ``--arch <id>``. Each config also carries a ``smoke()``
reduction (same family, tiny dims) used by per-arch CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "RGLRUConfig",
    "EncDecConfig",
    "VisionStubConfig",
    "ShapeConfig",
    "SHAPES",
    "register",
    "get_config",
    "list_archs",
    "pad_to_multiple",
]


def pad_to_multiple(x: int, mult: int = 128) -> int:
    """Pad a dimension (vocab, experts, ...) up for sharding divisibility."""
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int  # routed experts (pre-padding)
    top_k: int
    expert_ff: int  # d_ff per routed expert
    shared_ff: int = 0  # total d_ff of the always-on shared expert(s)
    first_dense_layers: int = 0  # leading dense layers (deepseek-moe: 1)
    first_dense_ff: int = 0  # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_softcap: float | None = None

    @property
    def num_experts_padded(self) -> int:
        """Experts padded to a multiple of 16 so EP divides the model axis
        (qwen2-moe: 60 -> 64; dummy experts have zero weights and are never
        routed to)."""
        return pad_to_multiple(self.num_experts, 16)


@dataclasses.dataclass(frozen=True)
class SSMConfig:  # Mamba-1 (falcon-mamba)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # default d_model // 16


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:  # Griffin / RecurrentGemma recurrent block
    lru_width: int | None = None  # default d_model
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class EncDecConfig:  # whisper
    num_encoder_layers: int = 24
    encoder_frames: int = 1500  # conv frontend is a STUB: precomputed frames


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:  # internvl2
    num_patches: int = 256  # ViT frontend is a STUB: precomputed patch embeds


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern, cycled over the depth: "global" | "local" | "recurrent"
    # | "ssm". len(pattern) is the scan-block size (compile-time constant).
    pattern: tuple[str, ...] = ("global",)
    window_size: int | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qkv_bias: bool = False
    activation: str = "silu"  # silu -> SwiGLU, gelu -> GeGLU
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    post_norm: bool = False  # gemma2 sandwich norm
    scale_embed: bool = False  # gemma family: embeddings × sqrt(d_model)
    tie_embeddings: bool = True
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    encdec: EncDecConfig | None = None
    vision: VisionStubConfig | None = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_policy: str = "nothing_saveable"
    # ops
    # "ref": plain materialized softmax | "chunked": a loop over KV chunks |
    # "pallas": in the port, the hand-written CUDA flash-attention kernel
    # (kernels/csrc/flash_attention.cu) on the card, its plain version on the CPU
    attn_impl: str = "ref"
    attn_chunk: int | None = None  # chunked attention for long prefill
    notes: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        return pad_to_multiple(self.vocab_size, 128)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_enc_dec(self) -> bool:
        return self.encdec is not None

    def num_params(self) -> int:
        """Parameter count (for 6·N·D model-FLOPs accounting)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_padded
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        per_kind = {}
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.qkv_bias:
            attn += (h + 2 * kv) * hd
        # gated MLPs (SwiGLU/GeGLU) have 3 matrices; plain GELU (whisper) 2.
        mlp_mats = 2 if self.activation == "gelu_plain" else 3
        per_kind["global"] = attn + mlp_mats * d * ff
        per_kind["local"] = per_kind["global"]
        if self.rglru is not None:
            w = self.rglru.lru_width or d
            # in/out proj + conv + gates (Griffin recurrent block) + mlp
            rec = 2 * d * w + self.rglru.conv_width * w + 2 * w * w + w * d
            per_kind["recurrent"] = rec + 3 * d * ff
        if self.ssm is not None:
            e = self.ssm.expand * d
            dtr = self.ssm.dt_rank or d // 16
            s = self.ssm.d_state
            per_kind["ssm"] = (
                2 * d * e  # in_proj (x, z)
                + self.ssm.d_conv * e
                + e * (dtr + 2 * s)  # x_proj
                + dtr * e  # dt_proj
                + e * s  # A_log
                + e  # D
                + e * d  # out_proj
            )
        if self.moe is not None:
            m = self.moe
            routed = m.num_experts * 3 * d * m.expert_ff
            shared = 3 * d * m.shared_ff
            router = d * m.num_experts
            per_kind["global"] = attn + routed + shared + router
        count = 0
        layers = self.layer_kinds()
        for kind in layers:
            count += per_kind[kind]
        if self.moe is not None and self.moe.first_dense_layers:
            # those layers were counted as MoE; swap in dense ff
            m = self.moe
            count -= m.first_dense_layers * (
                m.num_experts * 3 * d * m.expert_ff + 3 * d * m.shared_ff + d * m.num_experts
            )
            count += m.first_dense_layers * 3 * d * m.first_dense_ff
        if self.is_enc_dec:
            enc_attn = attn
            enc = self.encdec.num_encoder_layers * (enc_attn + mlp_mats * d * ff)
            cross = len(layers) * attn  # decoder cross-attention
            count += enc + cross
        return int(total + count)

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        d = self.d_model
        inactive = (
            (len(self.layer_kinds()) - m.first_dense_layers)
            * (m.num_experts - m.top_k)
            * 3
            * d
            * m.expert_ff
        )
        return int(self.num_params() - inactive)

    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind sequence: pattern cycled to num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return (self.pattern * reps)[: self.num_layers]

    def scan_plan(self) -> tuple[int, tuple[str, ...]]:
        """(num_scanned_blocks, remainder_kinds). The scan body is one full
        pattern; a trailing partial pattern runs unscanned."""
        nb = self.num_layers // len(self.pattern)
        rem = self.layer_kinds()[nb * len(self.pattern) :]
        return nb, rem


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Archs allowed to run long_500k (SSM / hybrid with local-only attention).
LONG_CONTEXT_ARCHS = {"falcon-mamba-7b", "recurrentgemma-9b"}

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    table = _SMOKE if smoke else _REGISTRY
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return table[arch_id]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def shape_is_applicable(arch_id: str, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (DESIGN.md §Arch-applicability)."""
    if shape == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True
