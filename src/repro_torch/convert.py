"""Carry graph layouts and vertex state into the port as plain arrays.

The port imports nothing of the JAX package. A caller that holds that
package's ``EdgeList``/``DSSSGraph`` reads their fields off as numpy arrays
and ints (``dataclasses.asdict`` or ``vars`` gives them) and builds the
port's counterparts here; attributes and aux dicts come over the same way.
This is how the parity tests feed both packages one layout and one state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dsss import DSSSGraph
from repro_torch.device import resolve_device
from repro_torch.graph.preprocess import EdgeList

__all__ = ["edgelist_from_arrays", "dsss_from_arrays", "attrs_from_numpy", "aux_from_numpy"]


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
