"""Model facade: one object per config, over the functional transformer.

Port of the JAX package's ``repro.models.model``. ``input_specs(cfg,
shape)`` gives every model input of a shape cell as a tensor on the
``meta`` device (shape and dtype, nothing allocated), PyTorch's
counterpart of ``jax.ShapeDtypeStruct``. The modality frontends are stubs:
the vision stub takes patch embeddings, the audio stub frame embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    Transformer,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    prefill,
)

__all__ = ["Model", "input_specs"]


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-device stand-ins for every input of this (arch, shape): ``tokens``
    (and ``labels`` to train; fewer by the patches with a vision stub),
    ``patch_embeds`` and ``frames`` in bfloat16, or for decode ``token``,
    ``pos`` and the ``cache`` of :func:`init_decode_cache`."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        names = ("tokens", "labels") if shape.kind == "train" else ("tokens",)
        n_tok = s - cfg.vision.num_patches if cfg.vision is not None else s
        specs = {name: spec((b, n_tok), torch.int32) for name in names}
        if cfg.vision is not None:
            specs["patch_embeds"] = spec((b, cfg.vision.num_patches, cfg.d_model), torch.bfloat16)
        if cfg.is_enc_dec:
            specs["frames"] = spec((b, cfg.encdec.encoder_frames, cfg.d_model), torch.bfloat16)
        return specs
    # decode: one new token against a cache of seq_len
    return {
        "token": spec((b, 1), torch.int32),
        "pos": spec((), torch.int32),
        "cache": init_decode_cache(cfg, b, s, device="meta"),
    }


class Model:
    """Thin facade over the transformer functions, bound to one device.

    ``device=None`` is the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, cfg: ModelConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, key: int | torch.Generator = 0) -> Transformer:
        return init_params(self.cfg, key, device=self.device)

    def apply(self, params: Transformer, tokens, **extra):
        """``extra``: ``patch_embeds=``, ``frames=``, ``return_hidden=``."""
        return forward(self.cfg, params, tokens, **extra)

    def prefill(self, params: Transformer, tokens, max_len: int, **extra):
        """``extra``: ``patch_embeds=``, ``frames=``."""
        return prefill(self.cfg, params, tokens, max_len, **extra)

    def decode(self, params: Transformer, cache, token, pos: int):
        return decode_step(self.cfg, params, cache, token, pos)

    def init_cache(self, batch: int, max_len: int):
        return init_decode_cache(self.cfg, batch, max_len, device=self.device)
