"""Adafactor (factored second moments), port of ``repro.optim.adafactor``.

For matrices, the second-moment estimate is factored into per-row and
per-column accumulators (Shazeer & Stern, 2018), cutting optimizer memory
from 2x params to ~1x + O(rows+cols). The state is keyed by parameter
name: ``{"acc": {name: {"vr", "vc"} or {"v"}}, "count"}``.

Each parameter tensor is one unit, as in the reference; but the reference
stacks its scanned layers into one tensor, so over a model its update RMS
clip spans a whole stack where the port's spans one layer, and a stack of
1-D parameters is factored there and not here. On the same tensors the two
agree. :meth:`Adafactor.update` updates in place and returns the state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim._tree import device_of, named

__all__ = ["Adafactor"]


@dataclasses.dataclass(frozen=True)
class Adafactor:
    learning_rate: float | Callable = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0

    def init(self, params) -> dict:
        def make(p):
            f32 = {"dtype": torch.float32, "device": p.device}
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"acc": {n: make(p) for n, p in named(params).items()},
                "count": torch.zeros((), dtype=torch.int32, device=device_of(params))}

    def _lr(self, count):
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def update(self, grads, state: dict, params):
        """Returns ``(params, state)``, both updated in place."""
        count = state["count"] + 1
        beta = 1.0 - (count.float() + 1) ** -self.decay
        lr = self._lr(count)
        for n, p in named(params).items():
            acc = state["acc"][n]
            gf = grads[n].float()
            g2 = torch.square(gf) + self.eps
            if p.ndim >= 2:
                vr = beta * acc["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * acc["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=self.eps)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
                u = gf / torch.sqrt(vhat)
                acc["vr"].copy_(vr)
                acc["vc"].copy_(vc)
            else:
                v = beta * acc["v"] + (1 - beta) * g2
                u = gf / torch.sqrt(v)
                acc["v"].copy_(v)
            rms = torch.sqrt(torch.mean(torch.square(u)))
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            p.copy_((p - lr * u).to(p.dtype))
        state["count"] = count
        return params, state
