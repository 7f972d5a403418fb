"""Carry graph layouts, vertex state and LM weights into the port as plain arrays.

The port imports nothing of the JAX package. A caller that holds that
package's ``EdgeList``/``DSSSGraph`` reads their fields off as numpy arrays
and ints (``dataclasses.asdict`` or ``vars`` gives them) and builds the
port's counterparts here; attributes and aux dicts come over the same way,
and so does an LM parameter tree (:func:`lm_params_from_numpy`). This is
how the parity tests feed both packages one layout, one state and one set
of weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dsss import DSSSGraph
from repro_torch.device import resolve_device
from repro_torch.graph.preprocess import EdgeList

__all__ = [
    "edgelist_from_arrays",
    "dsss_from_arrays",
    "attrs_from_numpy",
    "aux_from_numpy",
    "lm_params_from_numpy",
]


def _array(v):
    return None if v is None else np.array(v)


def edgelist_from_arrays(fields: dict) -> EdgeList:
    """An :class:`EdgeList` from its fields as numpy arrays and ints."""
    return EdgeList(
        src=np.array(fields["src"], dtype=np.int32),
        dst=np.array(fields["dst"], dtype=np.int32),
        n=int(fields["n"]),
        out_degree=np.array(fields["out_degree"], dtype=np.int32),
        in_degree=np.array(fields["in_degree"], dtype=np.int32),
        id_to_index=np.array(fields["id_to_index"], dtype=np.int64),
        weights=_array(fields.get("weights")),
    )


def dsss_from_arrays(fields: dict) -> DSSSGraph:
    """A :class:`DSSSGraph` from its fields; ``edgelist`` may be a field dict."""
    el = fields["edgelist"]
    if not isinstance(el, EdgeList):
        el = edgelist_from_arrays(el if isinstance(el, dict) else vars(el))
    kw = {}
    for f in dataclasses.fields(DSSSGraph):
        if f.name == "edgelist":
            continue
        v = fields[f.name]
        if f.name in ("n", "m", "P", "interval_size"):
            kw[f.name] = int(v)
        elif f.name == "src_sorted":
            kw[f.name] = bool(v)
        else:
            kw[f.name] = _array(v)
    return DSSSGraph(edgelist=el, **kw)


def attrs_from_numpy(a, device: str | torch.device | None = None, dtype=None) -> torch.Tensor:
    """A numpy attribute array as a tensor on ``device`` (same bits).

    ``device=None`` is the CUDA card and raises without one; pass ``"cpu"``.
    """
    t = torch.from_numpy(np.array(a))
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def aux_from_numpy(aux: dict, device: str | torch.device | None = None) -> dict:
    """An aux dict of numpy arrays and scalars as tensors on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in aux.items()}


def _flatten(tree: dict, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = v
    return out


def lm_params_from_numpy(cfg, tree: dict, device: str | torch.device | None = None):
    """A :class:`repro_torch.models.Transformer` holding the weights of a
    JAX parameter tree given as numpy arrays
    (``jax.tree.map(np.asarray, Model(cfg).init(key))``).

    The reference stacks its scanned layers: ``tree["blocks"][pos]`` holds,
    with a leading dimension ``nb``, pattern position ``pos`` of each scanned
    block, and layer ``b`` of it is layer ``len(pre) + b·len(pattern) + pos``.
    Each array is cast as the port stores it (``cfg.dtype`` for matrices,
    ``cfg.param_dtype`` for norm scales and for what the reference reads in
    float32: the MoE router, Mamba's ``A_log`` and ``D``, the RG-LRU gates),
    rounding to nearest even.
    ``device=None`` is the CUDA card and raises without one.
    """
    from repro_torch.models.transformer import Transformer, _plan

    params = Transformer(cfg, device=device)
    _, nb, pat, _ = _plan(cfg)
    stacks = [_flatten(stack, "", {}) for stack in tree["blocks"]] if nb else []
    layers = [_flatten(blk, "", {}) for blk in tree.get("pre", [])]
    for b in range(nb):
        layers += [{k: v[b] for k, v in stacks[pos].items()} for pos in range(len(pat))]
    layers += [_flatten(blk, "", {}) for blk in tree.get("tail", [])]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"the tree holds {len(layers)} layers, {cfg.name} has {cfg.num_layers}")
    flat = _flatten({k: v for k, v in tree.items() if k not in ("pre", "blocks", "tail")}, "", {})
    for i, layer in enumerate(layers):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    state = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    params.load_state_dict(state, strict=True)
    return params
