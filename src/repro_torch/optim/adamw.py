"""AdamW, hand-rolled as the reference's (port of ``repro.optim.adamw``).

The reference's state is a pytree mirroring the parameters; the port's is
keyed by parameter name: ``{"mu": {name: m}, "nu": {name: v}, "count"}``.
``convert.lm_params_to_numpy`` maps ``mu`` and ``nu`` onto the reference's
tree (checkpoints). :meth:`AdamW.update` writes the new parameters and
moments into the given tensors (under ``torch.no_grad()``) and returns
them; the reference returns new ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.optim._tree import device_of, named

__all__ = ["AdamW", "OptState"]

OptState = dict  # {"mu": {name: tensor}, "nu": {name: tensor}, "count": int32 tensor}


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    # params -> {name: bool}: which parameters take weight decay (default:
    # those with more than one dimension)
    decay_mask: Callable[[Any], dict] | None = None

    def init(self, params) -> OptState:
        # Moments always float32, whatever the parameters' dtype.
        ps = named(params)
        zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in ps.items()}  # noqa: E731
        return {"mu": zeros(), "nu": zeros(),
                "count": torch.zeros((), dtype=torch.int32, device=device_of(params))}

    def _lr(self, count):
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """Returns ``(params, state)``, both updated in place."""
        ps = named(params)
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        cf = count.float()
        c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
        c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf
        lr = self._lr(count)
        wd = self.weight_decay
        mask = self.decay_mask(params) if self.decay_mask is not None else {n: p.ndim > 1 for n, p in ps.items()}
        for n, p in ps.items():
            g = grads[n].float()
            m, v = state["mu"][n], state["nu"][n]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if wd and mask[n]:
                upd = upd + wd * p
            p.copy_((p - lr * upd).to(p.dtype))
        state["count"] = count
        return params, state
