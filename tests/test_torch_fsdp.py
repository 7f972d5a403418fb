"""The FSDP training profile of the port against the JAX package's, on the CPU.

The reference runs in a subprocess on four forced host devices, on a
(2, 2) mesh over ``("data", "model")`` whose axes are Auto-typed (on jax
0.9 ``jax.make_mesh`` makes Explicit axes, under which the reference's
FSDP forward does not trace), under ``activate_mesh(mesh,
TRAIN_FSDP_RULES)``. The port runs the same inputs on four gloo CPU ranks
(``spawn_gloo``) on the same mesh, each rank holding its shards.

* The MoE layer through ``_moe_fsdp_local`` (8 × 64 and 8 × 48 tokens:
  128 and 96 on a rank, under the dense path's 256, but the reference
  picks the branch by the global count) and through the dense path with
  the global per-expert sums (4 × 16 tokens): ``y`` and the aux scalars.
* One train step of ``deepseek-moe-16b-smoke`` and of ``gemma-2b-smoke``
  in float32 (AdamW, lr 1e-3, weight decay, clipping): the loss,
  ``grad_norm``, the metrics and every updated parameter, gathered; each
  rank's shard is its slice of the whole; the bytes gathered and summed
  equal their closed form; a state made under the mesh holds shards.
* On one rank ((1, 1) mesh) the FSDP step equals the unsharded step bit
  for bit.

Tolerances are PR 23's (``tests/test_torch_train.py``): float32 sums in
other orders. The MoE layer: ``y`` within 1e-5 (a few float32 ulps of
activations of order 1), aux within ``rtol=1e-5``. The step: metrics
``rtol=2e-5``. Parameters: PR 23 holds the unsharded step to
``atol=5e-5`` (5 % of lr), since AdamW's first step ``lr·g/(|g| + eps)``
moves an entry whose gradient cancels to within a few ``eps`` of zero by a
share of lr that the float32 summation order decides. Here every gradient
is also summed over the ranks (in rank order, where XLA reduce-scatters in
its own), which adds one more order to such entries: one of gemma's 12,288
``wq`` entries moved 5.3 % of lr. So each leaf is held to ``atol=1e-4`` (10 % of
lr), and all but 1 in 1,000 of its entries to ``5e-6`` (0.5 % of lr).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402,F401

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy  # noqa: E402
from repro_torch.core.distributed import spawn_gloo  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.models.moe import MoE, moe_apply  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.sharding import fsdp  # noqa: E402
from repro_torch.sharding.rules import (  # noqa: E402
    TRAIN_FSDP_RULES,
    NamedSharding,
    activate_mesh,
    named_sharding,
    param_logical_axes,
    param_specs,
    spec_for,
    tree_shardings,
)
from repro_torch.train import make_train_state, make_train_step  # noqa: E402
from repro_torch.train.state import decay_mask  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 2), ("data", "model"))
MOE_ARCHS = ("deepseek-moe-16b", "qwen2-moe-a2.7b")
MOE_SHAPES = ((8, 64), (8, 48), (4, 16))  # global (B, S): sorted, sorted, dense
TRAIN_ARCHS = ("deepseek-moe-16b", "gemma-2b")
LR, WD = 1e-3, 0.01

_JAX_SCRIPT = """
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import optim
from repro.configs import get_config
from repro.models import Model
from repro.models.moe import moe_apply, moe_init
from repro.sharding.rules import TRAIN_FSDP_RULES, activate_mesh, tree_shardings
from repro.train.state import TrainState
from repro.train.step import make_train_step
moe_archs, moe_shapes, train_archs, lr, wd = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {"moe": {}, "train": {}}
for arch in moe_archs:
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    p = moe_init(jax.random.PRNGKey(1), cfg)
    for b, s in moe_shapes:
        x = np.random.default_rng(b * 100 + s).standard_normal((b, s, cfg.d_model)).astype(np.float32)
        with mesh, activate_mesh(mesh, TRAIN_FSDP_RULES):
            y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg))(p, jnp.asarray(x))
        out["moe"][arch, b, s] = (jax.tree.map(np.asarray, p), x, np.asarray(y),
                                  {k: float(v) for k, v in aux.items()})
for arch in train_archs:
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = jax.jit(Model(cfg).init)(jax.random.PRNGKey(0))
    opt = optim.AdamW(learning_rate=lr, weight_decay=wd)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (8, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, -3:] = -1
    with mesh, activate_mesh(mesh, TRAIN_FSDP_RULES):
        st = jax.device_put(state, tree_shardings(state, mesh, TRAIN_FSDP_RULES))
        new, m = jax.jit(make_train_step(cfg, opt))(st, {k: jnp.asarray(v) for k, v in batch.items()})
    out["train"][arch] = (jax.tree.map(np.asarray, params), batch, jax.tree.map(np.asarray, new["params"]),
                          {k: float(v) for k, v in m.items()})
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _moe_module(cfg, p) -> MoE:
    moe = MoE(cfg, device="cpu")
    with torch.no_grad():
        moe.router.copy_(torch.from_numpy(p["router"]))
        moe.wi.copy_(torch.from_numpy(p["wi"]))
        moe.wo.copy_(torch.from_numpy(p["wo"]))
        moe.shared.wi.copy_(torch.from_numpy(p["shared"]["wi"]))
        moe.shared.wo.copy_(torch.from_numpy(p["shared"]["wo"]))
    return moe


def _moe_shardings(cfg, mesh) -> dict:
    """The MoE's parameters by their paths in the reference's tree."""
    out = {}
    for name, p in MoE(cfg, device="meta").named_parameters():
        shape = tuple(p.shape)
        out[name] = named_sharding(param_logical_axes("moe/" + name.replace(".", "/"), shape), shape, mesh,
                                   TRAIN_FSDP_RULES)
    return out


def _rows(x: np.ndarray, mesh) -> NamedSharding:
    logical = ("batch",) + (None,) * (x.ndim - 1)
    return NamedSharding(mesh, spec_for(logical, x.shape, mesh, TRAIN_FSDP_RULES))


def _whole(cfg) -> Transformer:
    return Transformer(cfg, device="meta", master_weights=True)


def _traffic(cfg, mesh) -> tuple[int, int]:
    """The closed forms of one step's gathered and summed bytes on a rank:
    every parameter is gathered where it is read (a tied embedding twice: the
    tokens' lookup and the CE's head) and a layer's once more when backward
    recomputes it; each read's cotangent is summed once. (float32 compute:
    both move float32.)"""
    specs = param_specs(_whole(cfg), mesh, TRAIN_FSDP_RULES)
    shapes = {n: tuple(p.shape) for n, p in _whole(cfg).named_parameters()}
    size = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    gathered = reduced = 0
    for n, shape in shapes.items():
        nbytes = 4 * int(np.prod(shape))
        split = any(size[a] > 1 for e in specs[n] if e is not None for a in ((e,) if isinstance(e, str) else e))
        reads = 2 if n == "embed" and cfg.tie_embeddings else 1
        gathered += nbytes * (reads + n.startswith("layers.")) if split else 0
        reduced += nbytes * reads
    return gathered, reduced


def _rank(rank: int, ref: dict) -> dict:
    """One gloo rank of the (2, 2) mesh: every MoE case, then each train step."""
    torch.set_num_threads(1)
    mesh = make_mesh(*MESH, device="cpu")
    out = {"moe": {}, "train": {}, "coordinate": list(mesh.get_coordinate())}
    with activate_mesh(mesh, TRAIN_FSDP_RULES):
        for (arch, b, s), (p, x, _, _) in ref["moe"].items():
            cfg = _cfg(arch)
            moe = fsdp.shard_module_(_moe_module(cfg, p), _moe_shardings(cfg, mesh))
            x_local = _rows(x, mesh).shard(torch.from_numpy(x))
            with torch.no_grad():
                y, aux = moe_apply(moe, x_local, cfg)
            out["moe"][arch, b, s] = (y.numpy(), {k: float(v) for k, v in aux.items()})
        for arch, (params, batch, _, _) in ref["train"].items():
            cfg = _cfg(arch)
            tp = lm_params_from_numpy(cfg, params, device="cpu", master_weights=True)
            shardings = tree_shardings(tp, mesh, TRAIN_FSDP_RULES)
            fsdp.shard_module_(tp, shardings)
            opt = AdamW(learning_rate=LR, weight_decay=WD, decay_mask=decay_mask(cfg))
            st = {"params": tp, "opt_state": opt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
            g0, r0 = fsdp.gathered_bytes, fsdp.reduced_bytes
            st, m = make_train_step(cfg, opt)(st, {k: torch.from_numpy(v) for k, v in batch.items()})
            traffic = (fsdp.gathered_bytes - g0, fsdp.reduced_bytes - r0)
            named = dict(tp.named_parameters())
            with torch.no_grad():
                whole = {n: shardings[n].gather(p) for n, p in named.items()}
            fresh = make_train_state(cfg, opt, 0, device="cpu")
            fresh_shapes = {n: tuple(p.shape) for n, p in fresh["params"].named_parameters()}
            out["train"][arch] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "local": {n: p.detach().numpy().copy() for n, p in named.items()},
                "whole": lm_params_to_numpy(cfg, whole) if rank == 0 else None,
                "traffic": traffic, "closed_form": _traffic(cfg, mesh),
                "fresh_shapes": fresh_shapes,
                "moment_shapes": {n: tuple(v.shape) for n, v in fresh["opt_state"]["mu"].items()},
            }
    return out


def _rank_alone(rank: int, ref: dict) -> dict:
    """One rank on a (1, 1) mesh: the FSDP step against the unsharded step,
    with PyTorch's deterministic kernels (the embedding's backward, an
    index_put that accumulates, adds in no fixed order on the CPU
    otherwise)."""
    torch.use_deterministic_algorithms(True)
    mesh = make_mesh((1, 1), MESH[1], device="cpu")
    out = {}
    for arch, (params, batch, _, _) in ref["train"].items():
        cfg = _cfg(arch)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        runs = []
        for sharded in (True, False):
            tp = lm_params_from_numpy(cfg, params, device="cpu", master_weights=True)
            opt = AdamW(learning_rate=LR, weight_decay=WD, decay_mask=decay_mask(cfg))
            st = {"params": tp, "opt_state": opt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
            g0 = fsdp.gathered_bytes
            if sharded:
                with activate_mesh(mesh, TRAIN_FSDP_RULES):
                    fsdp.shard_module_(tp, tree_shardings(tp, mesh, TRAIN_FSDP_RULES))
                    st, m = make_train_step(cfg, opt)(st, tb)
            else:
                st, m = make_train_step(cfg, opt)(st, tb)
            runs.append((m, st, fsdp.gathered_bytes - g0))
        (m1, s1, g1), (m2, s2, _) = runs
        p1, p2 = dict(s1["params"].named_parameters()), dict(s2["params"].named_parameters())
        out[arch] = {
            "metrics_equal": set(m1) == set(m2) and all(torch.equal(m1[k], m2[k]) for k in m1),
            "params_equal": all(torch.equal(p1[n], p2[n]) for n in p1),
            "moments_equal": all(torch.equal(s1["opt_state"][k][n], s2["opt_state"][k][n])
                                 for k in ("mu", "nu") for n in p1),
            "gathered_bytes": g1,
        }
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_fsdp") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    import json

    args = json.dumps([MOE_ARCHS, MOE_SHAPES, TRAIN_ARCHS, LR, WD])
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, args, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(ref):
    return spawn_gloo(_rank, 4, ref)


@pytest.fixture(scope="module")
def alone(ref):
    return spawn_gloo(_rank_alone, 1, ref)[0]


def _coord_mesh():
    class M:  # shape-only stand-in: slices by a given coordinate
        shape = dict(zip(MESH[1], MESH[0]))

    return M()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("b,s", MOE_SHAPES, ids=[f"{b}x{s}" for b, s in MOE_SHAPES])
def test_moe_layer_matches_the_reference(ref, port, arch, b, s):
    _, x, y_ref, aux_ref = ref["moe"][arch, b, s]
    rows = _rows(x, _coord_mesh())
    assert set(aux_ref) == {"load_balance_loss", "dropped_fraction"}
    for r in port:
        y, aux = r["moe"][arch, b, s]
        want = rows.shard(torch.from_numpy(y_ref), coordinate=r["coordinate"]).numpy()
        assert y.shape == want.shape == (b // 4, s, x.shape[-1])
        np.testing.assert_allclose(y, want, atol=1e-5, rtol=1e-5)
        assert set(aux) == set(aux_ref)
        for k in aux_ref:
            np.testing.assert_allclose(aux[k], aux_ref[k], rtol=1e-5, atol=1e-7, err_msg=k)
    if b * s > 256:  # the sorted branch drops tokens at these capacities; the dense path never
        assert aux_ref["dropped_fraction"] > 0
    else:
        assert aux_ref["dropped_fraction"] == 0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_the_reference(ref, port, arch):
    _, _, new_ref, m_ref = ref["train"][arch]
    cfg = _cfg(arch)
    for r in port:
        got = r["train"][arch]["metrics"]
        assert set(got) == set(m_ref)
        for k in m_ref:
            np.testing.assert_allclose(got[k], m_ref[k], rtol=2e-5, err_msg=k)
    whole = port[0]["train"][arch]["whole"]
    flat_got, tree_got = jax.tree_util.tree_flatten(whole)
    flat_ref, tree_ref = jax.tree_util.tree_flatten(new_ref)
    assert tree_got == tree_ref
    for i, (g, w) in enumerate(zip(flat_got, flat_ref)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=f"leaf {i}")
        assert (np.abs(g - w) > 5e-6).mean() <= 1e-3, f"leaf {i}"


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_each_rank_holds_its_slice_and_moves_the_closed_form(port, arch):
    cfg = _cfg(arch)
    whole = port[0]["train"][arch]["whole"]
    from repro_torch.convert import lm_named_from_tree

    named_whole = lm_named_from_tree(cfg, whole)
    specs = param_specs(_whole(cfg), _coord_mesh(), TRAIN_FSDP_RULES)
    for r in port:
        out = r["train"][arch]
        assert out["traffic"] == out["closed_form"] and out["traffic"][0] > 0
        for n, local in out["local"].items():
            sh = NamedSharding(_coord_mesh(), specs[n])
            want = sh.shard(torch.from_numpy(np.asarray(named_whole[n])), coordinate=r["coordinate"]).numpy()
            np.testing.assert_array_equal(local, want, err_msg=n)
            assert out["fresh_shapes"][n] == out["moment_shapes"][n] == local.shape
            assert local.size * 4 == np.prod(named_whole[n].shape), n  # every tensor is split 4 ways


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_one_rank_fsdp_step_is_the_unsharded_step(alone, arch):
    out = alone[arch]
    assert out["metrics_equal"] and out["params_equal"] and out["moments_equal"]
    assert out["gathered_bytes"] == 0
