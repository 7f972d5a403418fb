"""Logical-axis sharding rules, divisibility-aware (port of ``repro.sharding.rules``).

Every parameter and activation dimension gets a *logical* name; rules map
logical names to mesh axes; :func:`spec_for` drops any mesh axis that does
not divide the concrete dimension (qwen2.5's 40 heads against model=16,
...), so every (arch × shape × mesh) cell has a spec.

Default mapping:
  batch   -> ("pod", "data")   DP across pods and the data axis
  embed   -> "data"            FSDP storage sharding of params/optimizer
  vocab/heads/kv_heads/mlp/experts -> "model"   TP / EP
  kv_seq  -> "model"           flash-decoding fallback when heads don't fit
  seq     -> "data"            long-context cache sharding (SP)
  layers  -> None              the reference's scan-stacked depth: replicated

The port's counterparts of JAX's types: :class:`PartitionSpec` is a tuple
of ``None``, an axis name or a tuple of names, entry for entry JAX's; a
mesh is a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``) or, for
specs alone, any object whose ``shape`` maps axis names to sizes.
:class:`NamedSharding` holds a mesh and a spec and gives the DTensor
placements, this rank's slice of a tensor and the gather back
(``sharding/fsdp.py``). The port's parameters are named and laid out per
layer (``layers.3.attn.wq``), the reference's are a tree whose scanned
layers are stacked (``blocks/0/attn/wq`` with a leading ``layers`` axis):
:func:`param_specs` keys each of the port's tensors by the reference's
path and gives it the stacked tensor's spec less that leading entry.

The port has no ``with_sharding_constraint``: each rank computes on plain
local tensors, so :func:`constrain` and :func:`maybe_constrain` check that
the spec can be built and return the tensor unchanged.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any

import torch

__all__ = [
    "LOGICAL_RULES",
    "spec_for",
    "named_sharding",
    "param_logical_axes",
    "param_specs",
    "tree_shardings",
    "batch_spec",
    "constrain",
]

# logical axis -> tuple of mesh axes to try (joined as a tuple spec entry)
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    # CE-loss logits keep vocab on "model": batch for the loss shards over
    # (pod, data) only, so the lm-head is never gathered.
    "batch_ce": ("pod", "data"),
    "embed": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "seq": (),
    "kv_seq": ("model",),
    # decode KV caches: sequence over "model" (flash-decoding style) — kv
    # head counts (8, 1, ...) rarely divide the 16-way model axis, cache
    # length always does. Batch still takes (pod, data).
    "cache_seq": ("model",),
    "layers": (),
    "conv": (),
    "state": (),
    "frames": (),
    "dt_rank": (),
    None: (),
}

# Serving profile: parameters are not FSDP-sharded over "data" (a decode
# step would otherwise gather every parameter once per token).
SERVING_RULES: dict[str, tuple[str, ...]] = dict(LOGICAL_RULES)
SERVING_RULES["embed"] = ()

# Train profile: pure FSDP / ZeRO-3. The batch is data-parallel over every
# mesh axis; parameters are 2-D sharded over (data, model) for storage and
# gathered (bf16) per layer; no tensor parallelism, and the MoE dispatch
# stays local to each rank (no expert parallelism). The vocab axis keeps
# "model" so embedding and lm-head stay 2-D sharded.
TRAIN_FSDP_RULES: dict[str, tuple[str, ...]] = dict(LOGICAL_RULES)
TRAIN_FSDP_RULES.update(
    batch=("pod", "data", "model"),
    embed=("data", "model"),
    vocab=("model",),
    heads=(),
    kv_heads=(),
    mlp=(),
    experts=(),
)


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (the dimension split over those axes, the
    first the major one)."""

    def __new__(cls, *entries):
        for e in entries:
            ok = e is None or isinstance(e, str) or (
                isinstance(e, tuple) and e and all(isinstance(a, str) for a in e))
            if not ok:
                raise TypeError(f"a spec entry is None, an axis name or a tuple of names, not {e!r}")
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s dimensions, or a stand-in's
    ``shape`` mapping."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return {str(k): int(v) for k, v in shape.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions have no names (make it with launch.mesh.make_mesh)")
    return dict(zip(names, (int(s) for s in shape)))


def entry_axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes, major first (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axes_that_divide(dim: int, axes: tuple[str, ...], mesh) -> tuple[str, ...]:
    """Greedily keep the prefix of mesh axes whose product divides dim."""
    shape = mesh_shape(mesh)
    kept: list[str] = []
    prod = 1
    for ax in axes:
        if ax not in shape:
            continue
        nxt = prod * shape[ax]
        if dim % nxt == 0:
            kept.append(ax)
            prod = nxt
        else:
            break
    return tuple(kept)


def spec_for(logical: tuple[str | None, ...], shape: tuple[int, ...], mesh, rules: dict | None = None
             ) -> PartitionSpec:
    """Build a PartitionSpec for a tensor with the given logical axes."""
    rules = rules or LOGICAL_RULES
    if len(logical) != len(shape):
        raise ValueError(f"{logical} vs {shape}")
    entries: list[Any] = []
    used: set[str] = set()
    for name, dim in zip(logical, shape):
        want = rules.get(name, ())
        want = tuple(a for a in want if a not in used)
        kept = _axes_that_divide(dim, want, mesh)
        used.update(kept)
        if not kept:
            entries.append(None)
        elif len(kept) == 1:
            entries.append(kept[0])
        else:
            entries.append(tuple(kept))
    return P(*entries)


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: how a tensor of the spec's rank
    lies over the mesh's ranks.

    :attr:`placements` gives DTensor's ``Shard(d)``/``Replicate()`` for each
    mesh dimension; :meth:`shard` this rank's slice (or any coordinate's);
    :meth:`gather` the whole tensor from this rank's slice, gathered over
    one mesh axis at a time with each entry's axes in reverse order (the
    reference's ``_gather_full``), differentiable (``sharding/fsdp.py``).
    """

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        shape = mesh_shape(mesh)
        seen: set[str] = set()
        for e in self.spec:
            for a in entry_axes(e):
                if a not in shape:
                    raise ValueError(f"{self.spec} names {a!r}, the mesh's axes are {tuple(shape)}")
                if a in seen:
                    raise ValueError(f"{self.spec} uses {a!r} twice")
                seen.add(a)

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_shape(self.mesh)}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dimension. A tensor dimension split
        over several axes must name them in the mesh's order (DTensor splits
        over mesh dimensions major first); other orders raise."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_shape(self.mesh))
        out: list = [Replicate()] * len(names)
        for d, e in enumerate(self.spec):
            dims = [names.index(a) for a in entry_axes(e)]
            if dims != sorted(dims):
                raise ValueError(f"{self.spec}: dimension {d} names mesh axes {entry_axes(e)} out of the "
                                 f"mesh's order {tuple(names)}; DTensor cannot place it")
            for m in dims:
                out[m] = Shard(d)
        return tuple(out)

    def num_shards(self, d: int) -> int:
        """How many pieces dimension ``d`` is cut into."""
        shape = mesh_shape(self.mesh)
        return math.prod(shape[a] for a in entry_axes(self.spec[d]))

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of one rank's slice of a tensor of ``shape``."""
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.spec):
            raise ValueError(f"a rank-{len(shape)} tensor against {self.spec}")
        out = []
        for d, s in enumerate(shape):
            n = self.num_shards(d)
            if s % n:
                raise ValueError(f"dimension {d} ({s}) does not split into {n} under {self.spec}")
            out.append(s // n)
        return tuple(out)

    def coordinate(self, coordinate=None) -> dict[str, int]:
        """Axis name -> index: ``coordinate`` as a mapping or a sequence in
        the mesh's axis order, or this rank's place on a ``DeviceMesh``."""
        names = list(mesh_shape(self.mesh))
        if coordinate is None:
            coordinate = self.mesh.get_coordinate()
            if coordinate is None:
                raise ValueError("this rank is not on the mesh")
        if not isinstance(coordinate, dict):
            coordinate = dict(zip(names, coordinate))
        return {a: int(coordinate[a]) for a in names}

    def shard(self, t: torch.Tensor, coordinate=None) -> torch.Tensor:
        """This rank's slice of the whole tensor ``t`` (a view), or the slice
        at ``coordinate``."""
        self.shard_shape(t.shape)
        shape, coord = mesh_shape(self.mesh), self.coordinate(coordinate)
        for d, e in enumerate(self.spec):
            axes = entry_axes(e)
            if not axes:
                continue
            idx = 0
            for a in axes:
                idx = idx * shape[a] + coord[a]
            size = t.shape[d] // self.num_shards(d)
            t = t.narrow(d, idx * size, size)
        return t

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this rank's slice (a collective: every rank
        of the mesh calls it). Under autograd its backward sums the
        cotangent over every rank and keeps this rank's slice."""
        from repro_torch.sharding import fsdp

        return fsdp.gather(local, self)


def named_sharding(logical, shape, mesh, rules=None) -> NamedSharding:
    return NamedSharding(mesh, spec_for(tuple(logical), tuple(shape), mesh, rules))


# ---------------------------------------------------------------------------
# Parameter-tree logical axes by the reference's path pattern.
# Paths look like "blocks/0/attn/wq" or "pre/0/moe/wi".
# ---------------------------------------------------------------------------
_PARAM_PATTERNS: list[tuple[str, tuple[str | None, ...]]] = [
    (r"embed$", ("vocab", "embed")),
    (r"lm_head$", ("vocab", "embed")),
    (r"attn/wq$", ("embed", "heads", "head_dim")),
    (r"attn/wk$", ("embed", "kv_heads", "head_dim")),
    (r"attn/wv$", ("embed", "kv_heads", "head_dim")),
    (r"attn/wo$", ("heads", "head_dim", "embed")),
    (r"attn/b[qkv]$", (None, None)),
    (r"cross/wq$", ("embed", "heads", "head_dim")),
    (r"cross/w[kv]$", ("embed", "kv_heads", "head_dim")),
    (r"cross/wo$", ("heads", "head_dim", "embed")),
    (r"cross/b[qkv]$", (None, None)),
    (r"mlp/wi$", ("embed", "mlp")),
    (r"mlp/wo$", ("mlp", "embed")),
    (r"shared/wi$", ("embed", "mlp")),
    (r"shared/wo$", ("mlp", "embed")),
    (r"moe/router$", ("embed", None)),
    (r"moe/wi$", ("experts", "embed", "expert_mlp")),
    (r"moe/wo$", ("experts", "expert_mlp", "embed")),
    # Mamba: shard the expanded inner dim (counts as "mlp")
    (r"ssm/in_proj$", ("embed", "mlp")),
    (r"ssm/conv_w$", ("conv", "mlp")),
    (r"ssm/conv_b$", ("mlp",)),
    (r"ssm/x_proj$", ("mlp", None)),
    (r"ssm/dt_proj$", ("dt_rank", "mlp")),
    (r"ssm/dt_bias$", ("mlp",)),
    (r"ssm/A_log$", ("mlp", "state")),
    (r"ssm/D$", ("mlp",)),
    (r"ssm/out_proj$", ("mlp", "embed")),
    # RG-LRU: lru width counts as "mlp"
    (r"rec/in_x$", ("embed", "mlp")),
    (r"rec/in_gate$", ("embed", "mlp")),
    (r"rec/conv_w$", ("conv", "mlp")),
    (r"rec/conv_b$", ("mlp",)),
    (r"rec/w[ax]$", ("mlp", None)),
    (r"rec/b[ax]$", ("mlp",)),
    (r"rec/lambda$", ("mlp",)),
    (r"rec/out$", ("mlp", "embed")),
    (r"(ln[12x]?|ln1_post|ln2_post|final_norm|lnx)/scale$", ("embed",)),
]

# decode-cache leaves (inputs/outputs of decode_step / prefill)
_CACHE_PATTERNS: list[tuple[str, tuple[str | None, ...]]] = [
    (r"kv/[kv]$", ("batch", "cache_seq", None, None)),
    (r"cross_kv/[kv]$", ("batch", "cache_seq", None, None)),
    (r"rec/h$", ("batch", "mlp")),
    (r"rec/conv$", ("batch", None, "mlp")),
    (r"ssm/conv$", ("batch", None, "mlp")),
    (r"ssm/ssm$", ("batch", "mlp", "state")),
]


def cache_logical_axes(path: str, shape: tuple[int, ...]) -> tuple[str | None, ...]:
    stacked = bool(re.search(r"(^|/)blocks/", path))
    for pat, axes in _CACHE_PATTERNS:
        if re.search(pat, path):
            return (("layers",) + tuple(axes)) if stacked else tuple(axes)
    return tuple([None] * len(shape))


def param_logical_axes(path: str, shape: tuple[int, ...]) -> tuple[str | None, ...]:
    """Logical axes for a parameter, by path suffix match. Scanned stacks
    ("blocks/...") carry a leading "layers" axis."""
    stacked = bool(re.search(r"(^|/)blocks/", path)) or bool(re.search(r"encoder/blocks", path))
    for pat, axes in _PARAM_PATTERNS:
        if re.search(pat, path):
            if stacked:
                return ("layers",) + tuple(axes)
            return tuple(axes)
    # default: replicate
    return tuple([None] * len(shape))


def reference_path(cfg, name: str) -> tuple[str, int | None]:
    """Where the reference's parameter tree holds the port's parameter
    ``name``: ``(path, stack)``, with ``stack`` the length of the leading
    axis the reference stacks it on (its scanned layers and the encoder's
    blocks), ``None`` for a tensor it does not stack."""
    from repro_torch.convert import _layer_places

    parts = name.split(".")
    if parts[0] == "layers":
        place = _layer_places(cfg)[int(parts[1])]
        rest = "/".join(parts[2:])
        if place[0] == "blocks":
            nb = sum(1 for p in _layer_places(cfg) if p[0] == "blocks" and p[1] == place[1])
            return f"blocks/{place[1]}/{rest}", nb
        return f"{place[0]}/{place[1]}/{rest}", None
    if parts[:2] == ["encoder", "blocks"]:
        return "encoder/blocks/" + "/".join(parts[3:]), cfg.encdec.num_encoder_layers
    return "/".join(parts), None


def _unstacked_spec(axes, shape, stack, mesh, rules) -> PartitionSpec:
    """The spec of a tensor that the reference holds at ``axes`` (its logical
    axes, stacked or not): computed on the stacked shape, less the leading
    ``layers`` entry, which is always replicated."""
    if stack is None:
        return spec_for(axes, tuple(shape), mesh, rules)
    full = spec_for(axes, (stack,) + tuple(shape), mesh, rules)
    if full[0] is not None:
        raise ValueError(f"the rules shard the stacked layers axis ({full}); the port keeps it per layer")
    return P(*full[1:])


def _cfg_of(tree, cfg):
    if cfg is not None:
        return cfg
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    if hasattr(tree, "cfg"):
        return tree.cfg
    raise ValueError("pass cfg=: the tree does not carry its config")


def _full_shapes(cfg) -> dict[str, tuple[int, ...]]:
    from repro_torch.models.transformer import Transformer

    meta = Transformer(cfg, device="meta", master_weights=True)
    return {n: tuple(p.shape) for n, p in meta.named_parameters()}


def param_specs(params, mesh, rules: dict | None = None, *, cfg=None) -> dict[str, PartitionSpec]:
    """``{name: PartitionSpec}`` for the port's parameters (a ``Transformer``,
    whole or holding shards, or a mapping of its names such as an AdamW
    moment), each by the reference's path and the whole tensor's shape
    (from ``cfg``, the module's own by default)."""
    cfg = _cfg_of(params, cfg)
    shapes = _full_shapes(cfg)
    names = dict(params.named_parameters()) if hasattr(params, "named_parameters") else params
    out = {}
    for name in names:
        path, stack = reference_path(cfg, name)
        shape = shapes[name]
        axes = param_logical_axes(path, shape if stack is None else (stack,) + shape)
        out[name] = _unstacked_spec(axes, shape, stack, mesh, rules)
    return out


def cache_specs(cache_shapes, mesh, *, cfg) -> list[dict]:
    """Specs mirroring the port's decode cache (one dict per layer,
    ``init_decode_cache``), each leaf by the reference's cache path
    (``blocks/<pos>/kv/k`` for a scanned layer, stacked). Always
    :data:`LOGICAL_RULES`, as the reference's."""
    from repro_torch.convert import _layer_places

    places = _layer_places(cfg)
    out = []
    for place, layer in zip(places, cache_shapes):
        prefix = f"blocks/{place[1]}" if place[0] == "blocks" else f"{place[0]}/{place[1]}"
        stack = sum(1 for p in places if p[0] == "blocks" and p[1] == place[1]) if place[0] == "blocks" else None

        def leaf_specs(node, path):
            if isinstance(node, dict):
                return {k: leaf_specs(v, f"{path}/{k}") for k, v in node.items()}
            shape = tuple(node.shape)
            axes = cache_logical_axes(path, shape if stack is None else (stack,) + shape)
            return _unstacked_spec(axes, shape, stack, mesh, None)

        out.append(leaf_specs(layer, prefix))
    return out


def tree_shardings(tree, mesh, rules: dict | None = None, *, cfg=None):
    """:class:`NamedSharding` for every tensor of the port's parameters or
    train state (``{"params", "opt_state", "step"}``), in the tree's layout:
    a module or a name-keyed mapping gives ``{name: sharding}``; a tensor
    that is not a parameter (a count, the step) is replicated."""
    cfg = _cfg_of(tree, cfg)
    specs = param_specs(_full_shapes(cfg), mesh, rules, cfg=cfg)

    def walk(node):
        if hasattr(node, "named_parameters"):
            return {n: NamedSharding(mesh, specs[n]) for n, _ in node.named_parameters()}
        if isinstance(node, dict):
            return {k: NamedSharding(mesh, specs[k]) if k in specs and isinstance(v, torch.Tensor) else walk(v)
                    for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return NamedSharding(mesh, P(*[None] * node.ndim))
        return node

    return walk(tree)


def batch_spec(mesh, batch: int) -> PartitionSpec:
    """Sharding for the leading batch dim of inputs."""
    axes = _axes_that_divide(batch, LOGICAL_RULES["batch"], mesh)
    if not axes:
        return P()
    return P(axes if len(axes) > 1 else axes[0])


def constrain(x, mesh, logical: tuple[str | None, ...]):
    """The reference's activation annotation: here each rank holds a plain
    local tensor, so the spec is built (which checks it) and ``x`` returned."""
    spec_for(logical, tuple(x.shape), mesh)
    return x


# ---------------------------------------------------------------------------
# Active-mesh context: a launcher activates a mesh and its rules; the MoE's
# FSDP branch and the train step read them (without a mesh: plain tensors).
# ---------------------------------------------------------------------------
_ACTIVE_MESH: list[tuple[Any, dict]] = []


@contextlib.contextmanager
def activate_mesh(mesh, rules: dict | None = None):
    _ACTIVE_MESH.append((mesh, rules or LOGICAL_RULES))
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.pop()


def active_mesh():
    return _ACTIVE_MESH[-1][0] if _ACTIVE_MESH else None


def active_rules() -> dict:
    return _ACTIVE_MESH[-1][1] if _ACTIVE_MESH else LOGICAL_RULES


_IN_SHARD_MAP: list[bool] = []


@contextlib.contextmanager
def suppress_constraints():
    """The reference's ``shard_map`` bodies turn annotations off; kept for
    its callers' shape (the port's annotations change nothing)."""
    _IN_SHARD_MAP.append(True)
    try:
        yield
    finally:
        _IN_SHARD_MAP.pop()


def maybe_constrain(x, *logical: str | None):
    """Divisibility-aware activation annotation; no-op without a mesh. With
    one, the spec is built under the active rules and ``x`` returned."""
    if not _ACTIVE_MESH or _IN_SHARD_MAP:
        return x
    mesh, rules = _ACTIVE_MESH[-1]
    spec_for(tuple(logical), tuple(x.shape), mesh, rules)
    return x
