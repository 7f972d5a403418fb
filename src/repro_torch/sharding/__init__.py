"""Divisibility-aware logical-axis sharding rules and the FSDP training
profile's collectives (port of the JAX package's ``repro.sharding``)."""
from repro_torch.sharding.rules import (
    LOGICAL_RULES,
    batch_spec,
    constrain,
    named_sharding,
    param_logical_axes,
    param_specs,
    spec_for,
    tree_shardings,
)

__all__ = [
    "LOGICAL_RULES",
    "batch_spec",
    "constrain",
    "named_sharding",
    "param_logical_axes",
    "param_specs",
    "spec_for",
    "tree_shardings",
]
