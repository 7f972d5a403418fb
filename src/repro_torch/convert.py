"""Carry graph layouts, vertex state and LM weights into the port as plain arrays.

The port imports nothing of the JAX package. A caller that holds that
package's ``EdgeList``/``DSSSGraph`` reads their fields off as numpy arrays
and ints (``dataclasses.asdict`` or ``vars`` gives them) and builds the
port's counterparts here; attributes and aux dicts come over the same way,
and so does an LM parameter tree (:func:`lm_params_from_numpy`). This is
how the parity tests feed both packages one layout, one state and one set
of weights, and :func:`lm_params_to_numpy` gives the reference's tree
back (checkpoints in the reference's format).
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
    "lm_params_to_numpy",
    "lm_named_from_tree",
    "lm_tree_ndims",
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


def _named(params) -> dict:
    """A module's named parameters, or a mapping of names as it is."""
    return dict(params.named_parameters()) if hasattr(params, "named_parameters") else params


def _nest(flat: dict) -> dict:
    """The inverse of :func:`_flatten`: dotted names to nested dicts."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def _layer_places(cfg) -> list[tuple]:
    """Where the reference's tree holds each of the port's layers, in layer
    order: ``("pre", i)``, ``("blocks", pos, b)`` (stacked at index ``b``)
    or ``("tail", i)``."""
    from repro_torch.models.transformer import _plan

    pre, nb, pat, tail = _plan(cfg)
    return ([("pre", i) for i in range(len(pre))]
            + [("blocks", pos, b) for b in range(nb) for pos in range(len(pat))]
            + [("tail", i) for i in range(len(tail))])


def lm_tree_ndims(cfg, params) -> dict[str, int]:
    """For each named parameter of ``params`` (a :class:`Transformer` or a
    mapping of its names), the number of dimensions the reference's tree
    gives it: one more than the port's for a layer the reference stacks
    (its scanned decoder layers and every encoder layer). The reference
    decides by these what its training casts to ``cfg.dtype`` and what its
    AdamW decays by default."""
    places = _layer_places(cfg)
    out = {}
    for name, t in _named(params).items():
        parts = name.split(".")
        stacked = (parts[0] == "layers" and places[int(parts[1])][0] == "blocks") or (
            parts[:2] == ["encoder", "blocks"])
        out[name] = t.ndim + int(stacked)
    return out


def _to_numpy(t):
    """A host copy as numpy; a meta tensor (a template) stays as it is."""
    if isinstance(t, torch.Tensor):
        if t.is_meta:
            return t
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _stack(trees: list):
    """Stack a list of equally shaped nested dicts leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees) if isinstance(trees[0], torch.Tensor) else np.stack(trees)


def lm_params_to_numpy(cfg, params) -> dict:
    """The reference's parameter tree holding ``params`` (a :class:`Transformer`,
    or any mapping of its parameter names to tensors, such as an optimizer's
    moments), as numpy arrays: ``embed``, ``final_norm``, ``lm_head``,
    ``pre``/``tail`` lists, ``blocks`` (one tree per pattern position, its
    layers stacked on a leading axis; ``None`` without whole patterns) and
    for an encoder-decoder ``encoder`` (``blocks`` stacked, ``final_norm``).
    The inverse of :func:`lm_params_from_numpy`; bfloat16 becomes float32
    (exactly), since numpy has no bfloat16. Meta tensors stay meta tensors
    (a restore template with nothing allocated)."""
    nested = _nest({k: _to_numpy(v) for k, v in _named(params).items()})
    layers = nested.pop("layers", {})
    tree = {k: v for k, v in nested.items() if k != "encoder"}
    tree.update(pre=[], blocks=[None] * len(cfg.pattern), tail=[])
    stacks: dict = {}
    for i, place in enumerate(_layer_places(cfg)):
        if place[0] == "blocks":
            stacks.setdefault(place[1], []).append(layers[str(i)])
        else:
            tree[place[0]].append(layers[str(i)])
    for pos, per in stacks.items():
        tree["blocks"][pos] = _stack(per)
    if "encoder" in nested:
        enc = nested["encoder"]
        blocks = enc["blocks"]
        tree["encoder"] = {"blocks": _stack([blocks[str(j)] for j in range(len(blocks))]),
                           "final_norm": enc["final_norm"]}
    return tree


def lm_params_from_numpy(cfg, tree: dict, device: str | torch.device | None = None, *,
                         master_weights: bool = False):
    """A :class:`repro_torch.models.Transformer` holding the weights of a
    JAX parameter tree given as numpy arrays
    (``jax.tree.map(np.asarray, Model(cfg).init(key))``).

    The reference stacks its scanned layers: ``tree["blocks"][pos]`` holds,
    with a leading dimension ``nb``, pattern position ``pos`` of each scanned
    block, and layer ``b`` of it is layer ``len(pre) + b·len(pattern) + pos``;
    an encoder-decoder's ``tree["encoder"]["blocks"]`` stacks the encoder's
    layers. Each array is cast as the port stores it (``cfg.dtype`` for
    matrices, ``cfg.param_dtype`` for norm scales and for what the reference
    reads in float32: the MoE router, Mamba's ``A_log`` and ``D``, the RG-LRU
    gates), rounding to nearest even; with ``master_weights`` (training)
    every array in ``cfg.param_dtype``, with gradients on.
    ``device=None`` is the CUDA card and raises without one.
    """
    from repro_torch.models.transformer import Transformer

    params = Transformer(cfg, device=device, master_weights=master_weights)
    state = {k: torch.from_numpy(np.array(v)) for k, v in lm_named_from_tree(cfg, tree).items()}
    with torch.no_grad():
        params.load_state_dict(state, strict=True)
    return params


def lm_named_from_tree(cfg, tree: dict) -> dict:
    """The port's parameter names for the leaves of a reference tree (the
    inverse of :func:`lm_params_to_numpy`'s layout; leaves as given)."""
    stacks = [_flatten(st, "", {}) if st else {} for st in tree.get("blocks", [])]
    n_layers = sum(len(tree.get(k, [])) for k in ("pre", "tail")) + sum(
        len(next(iter(st.values()))) for st in stacks if st)
    if n_layers != cfg.num_layers:
        raise ValueError(f"the tree holds {n_layers} layers, {cfg.name} has {cfg.num_layers}")
    flat = {}
    for i, place in enumerate(_layer_places(cfg)):
        if place[0] == "blocks":
            layer = {k: v[place[2]] for k, v in stacks[place[1]].items()}
        else:
            layer = _flatten(tree[place[0]][place[1]], "", {})
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    flat.update(_flatten({k: v for k, v in tree.items() if k not in ("pre", "blocks", "tail", "encoder")},
                         "", {}))
    if "encoder" in tree:
        enc = _flatten(tree["encoder"]["blocks"], "", {})
        for j in range(len(next(iter(enc.values())))):
            flat.update({f"encoder.blocks.{j}.{k}": v[j] for k, v in enc.items()})
        flat.update(_flatten({"final_norm": tree["encoder"]["final_norm"]}, "encoder.", {}))
    return flat
