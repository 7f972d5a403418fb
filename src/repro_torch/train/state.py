"""Train state + construction helpers (port of ``repro.train.state``).

The state is the reference's plain dict, ``{"params", "opt_state",
"step"}``: ``params`` a :class:`~repro_torch.models.Transformer` holding
float32 master weights with gradients on (``master_weights=True``),
``opt_state`` the optimizer's name-keyed state, ``step`` an int32 tensor.
:func:`checkpoint_tree` lays it out as the reference's train-state tree
(the files of ``CheckpointManager`` are then the JAX package's), and
:func:`load_checkpoint_tree` copies such a tree back into a state.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.convert import lm_named_from_tree, lm_params_to_numpy, lm_tree_ndims

__all__ = [
    "TrainState",
    "make_train_state",
    "abstract_train_state",
    "decay_mask",
    "checkpoint_tree",
    "load_checkpoint_tree",
]


def TrainState(params, opt_state, step) -> dict:
    """Plain-dict train state (checkpoint-friendly)."""
    return {"params": params, "opt_state": opt_state, "step": step}


def make_train_state(cfg, optimizer, key: int | torch.Generator = 0, *, device=None) -> dict:
    """Fresh weights drawn from ``key`` (a seed or a ``torch.Generator``),
    stored as float32 masters on ``device`` (``None``: the CUDA card).
    Under an active mesh each rank draws the whole weights, keeps its shard
    of each (``sharding.rules.tree_shardings``) and makes the optimizer's
    moments for the shards alone."""
    from repro_torch.models import init_params
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.rules import active_mesh, active_rules, tree_shardings

    params = init_params(cfg, key, device=device, master_weights=True)
    mesh = active_mesh()
    if mesh is not None:
        fsdp.shard_module_(params, tree_shardings(params, mesh, active_rules()))
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=params.device))


def abstract_train_state(cfg, optimizer) -> Any:
    """The train state on the ``meta`` device: every shape and dtype, nothing
    allocated (the reference's ``jax.eval_shape`` of it)."""
    from repro_torch.models import Transformer

    params = Transformer(cfg, device="meta", master_weights=True)
    return TrainState(params, optimizer.init(params), torch.zeros((), dtype=torch.int32, device="meta"))


def decay_mask(cfg):
    """AdamW's default weight-decay mask as the reference applies it: a
    parameter decays when its array in the reference's tree has more than
    one dimension, and the reference stacks its scanned layers (so their
    norm scales and biases decay there)."""
    return lambda params: {n: d > 1 for n, d in lm_tree_ndims(cfg, params).items()}


def _opt_tree(cfg, opt_state: dict) -> dict:
    return {k: v if k == "count" else lm_params_to_numpy(cfg, v) for k, v in opt_state.items()}


def checkpoint_tree(cfg, state: dict) -> dict:
    """The state as the reference's train-state tree of host arrays (meta
    tensors for a state from :func:`abstract_train_state`: a template)."""
    return {"params": lm_params_to_numpy(cfg, state["params"]),
            "opt_state": _opt_tree(cfg, state["opt_state"]), "step": state["step"]}


@torch.no_grad()
def load_checkpoint_tree(cfg, state: dict, tree: dict) -> dict:
    """Copy a reference-layout tree (numpy arrays) into ``state`` in place."""
    def load(named: dict, sub: dict) -> None:
        for n, a in lm_named_from_tree(cfg, sub).items():
            named[n].copy_(torch.from_numpy(a))

    load(dict(state["params"].named_parameters()), tree["params"])
    for k, v in tree["opt_state"].items():
        if k == "count":
            state["opt_state"]["count"].copy_(torch.from_numpy(v))
        else:
            load(state["opt_state"][k], v)
    state["step"].copy_(torch.from_numpy(tree["step"]))
    return state
