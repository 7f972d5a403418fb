"""The port's sharding rules against the JAX package's, on the CPU.

``spec_for``, ``param_specs``, ``cache_specs`` and ``batch_spec`` of
``repro_torch.sharding.rules`` are held entry for entry against
``repro.sharding.rules``: every registered config at full size (the
reference's ``jax.eval_shape`` of its parameters and decode cache against
the port's meta tensors), on the meshes (16, 16), (2, 16, 16), (2, 2) and
(4, 2) given as shape-only stand-ins, under the three rule sets. The port
keeps each layer apart where the reference stacks its scanned layers, so a
stacked leaf's spec is the port's with a leading ``None`` (the ``layers``
axis). A hypothesis property draws logical axes, shapes, meshes and rules:
the port's spec is the reference's, the kept axes divide each dimension
and no axis is used twice. ``NamedSharding``'s placements and slices are
checked by reassembling every rank's slice.
"""
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.transformer import _plan as j_plan  # noqa: E402
from repro.models.transformer import init_decode_cache as j_init_decode_cache  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import lm_named_from_tree  # noqa: E402
from repro_torch.models import Transformer, init_decode_cache  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
RULES = {"logical": "LOGICAL_RULES", "serving": "SERVING_RULES", "train_fsdp": "TRAIN_FSDP_RULES"}
ARCHS = list_archs()
# (global batch, max_len): decode_32k, and long_500k for the archs that take it
CACHES = ((128, 32768), (1, 524288))


def _mesh(name):
    shape, axes = MESHES[name]

    class M:  # spec_for reads only mesh.shape
        pass

    m = M()
    m.shape = dict(zip(axes, shape))
    return m


def _entries(spec) -> tuple:
    return tuple(spec)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    """The reference's parameter shapes (``jax.eval_shape`` of its init)."""
    return jax.eval_shape(JModel(j_get_config(arch)).init, jax.random.PRNGKey(0))


def _ref_params_by_port_name(arch, mesh, rule_name) -> dict:
    """The reference's spec of each leaf of its parameter tree, keyed by the
    port's parameter names. A stacked leaf's spec is wrapped in an object
    array as long as its stack, so that the port's layer mapping
    (``lm_named_from_tree``) gives each of its layers that spec."""
    shapes = _ref_shapes(arch)
    specs = jrules.param_specs(shapes, mesh, getattr(jrules, RULES[rule_name]))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for (kp, leaf), spec in zip(flat, treedef.flatten_up_to(specs)):
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        if "blocks/" in path:
            arr = np.empty(leaf.shape[0], dtype=object)
            for i in range(leaf.shape[0]):
                arr[i] = _entries(spec)
            leaves.append(arr)
        else:
            leaves.append(_entries(spec))
    return lm_named_from_tree(get_config(arch), jax.tree_util.tree_unflatten(treedef, leaves))


@pytest.mark.parametrize("rule_name", list(RULES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh_name, rule_name):
    mesh = _mesh(mesh_name)
    cfg = get_config(arch)
    meta = Transformer(cfg, device="meta", master_weights=True)
    want = _ref_params_by_port_name(arch, mesh, rule_name)
    got = rules.param_specs(meta, mesh, getattr(rules, RULES[rule_name]))
    assert set(got) == set(want)
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    for name, spec in got.items():
        assert isinstance(spec, rules.PartitionSpec)
        ref = want[name]
        if len(ref) == len(shapes[name]) + 1:  # the reference stacks this layer
            assert ref[0] is None, name
            ref = ref[1:]
        assert _entries(spec) == ref, name
        rules.NamedSharding(mesh, spec).shard_shape(shapes[name])  # the spec splits the whole tensor


def _ref_cache_by_port_layer(arch, mesh, batch, max_len) -> list:
    """The reference's cache specs, one dict per layer in the port's order."""
    jcfg = j_get_config(arch)
    shapes = jax.eval_shape(lambda: j_init_decode_cache(jcfg, batch, max_len))
    specs = jrules.cache_specs(shapes, mesh)
    pre, nb, pat, tail = j_plan(jcfg)
    layers = [specs["pre"][i] for i in range(len(pre))]
    layers += [specs["blocks"][pos] for _ in range(nb) for pos in range(len(pat))]
    layers += [specs["tail"][i] for i in range(len(tail))]
    return layers


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mesh_name):
    from repro.configs.base import shape_is_applicable

    mesh = _mesh(mesh_name)
    cfg = get_config(arch)
    for batch, max_len in CACHES:
        if max_len > 32768 and not shape_is_applicable(arch, "long_500k"):
            continue
        cache = init_decode_cache(cfg, batch, max_len, device="meta")
        got = rules.cache_specs(cache, mesh, cfg=cfg)
        want = _ref_cache_by_port_layer(arch, mesh, batch, max_len)
        assert len(got) == len(want) == cfg.num_layers
        for i, (g, w) in enumerate(zip(got, want)):
            gl = jax.tree_util.tree_flatten_with_path(g, is_leaf=lambda x: isinstance(x, rules.PartitionSpec))[0]
            wl = jax.tree_util.tree_flatten_with_path(
                w, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
            assert [jax.tree_util.keystr(k) for k, _ in gl] == [jax.tree_util.keystr(k) for k, _ in wl], i
            leaves = jax.tree_util.tree_leaves(cache[i])
            for (key, gs), (_, ws), t in zip(gl, wl, leaves):
                ws = _entries(ws)
                if len(ws) == t.ndim + 1:  # a scanned layer's stacked cache
                    assert ws[0] is None
                    ws = ws[1:]
                assert _entries(gs) == ws, (i, jax.tree_util.keystr(key))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_matches_the_reference(mesh_name):
    mesh = _mesh(mesh_name)
    for batch in (1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 64, 128, 256, 512, 1000, 1024):
        assert _entries(rules.batch_spec(mesh, batch)) == _entries(jrules.batch_spec(mesh, batch)), batch


LOGICAL = [k for k in jrules.LOGICAL_RULES if k is not None] + [None]


@settings(max_examples=200, deadline=None)
@given(
    mesh_name=st.sampled_from(list(MESHES)),
    rule_name=st.sampled_from(list(RULES)),
    axes=st.lists(st.sampled_from(LOGICAL), min_size=0, max_size=5),
    dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 40, 60, 64, 96, 128, 256, 1000, 4096, 32768]),
                  min_size=5, max_size=5),
)
def test_spec_for_property(mesh_name, rule_name, axes, dims):
    """The reference's spec entry for entry; kept axes divide each dim; no
    axis twice."""
    mesh = _mesh(mesh_name)
    shape = tuple(dims[: len(axes)])
    got = rules.spec_for(tuple(axes), shape, mesh, getattr(rules, RULES[rule_name]))
    want = jrules.spec_for(tuple(axes), shape, mesh, getattr(jrules, RULES[rule_name]))
    assert _entries(got) == _entries(want)
    used = []
    for dim, e in zip(shape, got):
        kept = rules.entry_axes(e)
        assert dim % int(np.prod([mesh.shape[a] for a in kept])) == 0
        used += kept
    assert len(used) == len(set(used))


def test_rule_sets_equal_the_reference():
    for name in RULES.values():
        assert getattr(rules, name) == getattr(jrules, name), name
    assert rules.__all__ == jrules.__all__


def test_param_logical_axes_match_the_reference():
    for path, shape in (("params/blocks/0/attn/wq", (18, 2048, 8, 256)), ("mu/embed", (256128, 2048)),
                        ("params/pre/0/moe/wi", (64, 2048, 2816)), ("encoder/blocks/ln1/scale", (24, 1024)),
                        ("tail/0/rec/lambda", (4096,)), ("x/unknown", (3, 4))):
        assert rules.param_logical_axes(path, shape) == jrules.param_logical_axes(path, shape)
    for path, shape in (("blocks/0/kv/k", (4, 8, 64, 1, 256)), ("pre/0/rec/h", (8, 4096)), ("a/b", (2,))):
        assert rules.cache_logical_axes(path, shape) == jrules.cache_logical_axes(path, shape)


def test_named_sharding_placements_and_slices():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh("4x2")
    P = rules.PartitionSpec
    assert rules.NamedSharding(mesh, P(("data", "model"), None)).placements == (Shard(0), Shard(0))
    assert rules.NamedSharding(mesh, P(None, "model")).placements == (Replicate(), Shard(1))
    assert rules.NamedSharding(mesh, P("model", "data")).placements == (Shard(1), Shard(0))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        rules.NamedSharding(mesh, P(("model", "data"))).placements
    with pytest.raises(ValueError, match="twice"):
        rules.NamedSharding(mesh, P("data", "data"))
    t = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    for spec in (P(("data", "model"), None, None), P("model", None, "data"), P(None, "model", None), P()):
        if len(spec) == 0:
            spec = P(None, None, None)
        sh = rules.NamedSharding(mesh, spec)
        pieces = {}
        for d in range(4):
            for m in range(2):
                local = sh.shard(t, coordinate={"data": d, "model": m})
                assert tuple(local.shape) == sh.shard_shape(t.shape)
                pieces[d, m] = local
        # every element lands in the slices of as many ranks as the spec replicates it over
        copies = 8 // int(np.prod([sh.num_shards(i) for i in range(3)]))
        seen = torch.cat([p.reshape(-1) for p in pieces.values()])
        assert torch.equal(torch.bincount(seen, minlength=t.numel()), torch.full((t.numel(),), copies))
    sh = rules.NamedSharding(mesh, P(("data", "model"), None, None))
    joined = torch.cat([sh.shard(t, coordinate=(d, m)) for d in range(4) for m in range(2)])
    assert torch.equal(joined, t)  # "data" the major axis, as JAX's tuple entry
    assert rules.constrain(t, mesh, ("batch", None, None)) is t
    with rules.activate_mesh(mesh, rules.TRAIN_FSDP_RULES):
        assert rules.active_rules() is rules.TRAIN_FSDP_RULES and rules.active_mesh() is mesh
        assert rules.maybe_constrain(t, "batch", None, None) is t
    assert rules.active_mesh() is None and rules.active_rules() is rules.LOGICAL_RULES
