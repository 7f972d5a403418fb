"""The MoE layer of the port against the JAX package's, on the CPU.

Smoke configs of deepseek-moe-16b (8 experts, top 2, shared experts) and
qwen2-moe-a2.7b (6 experts padded to 16, top 2, QKV bias elsewhere),
float32, weights from the JAX init carried across by name, inputs from
numpy seeds. Both paths: the dropless dense path (T ≤ 256 tokens) and the
sorted capacity dispatch (T > 256), where the same routing drops the same
assignments. Outputs (magnitudes up to ~5) are held to ``atol=rtol=2e-5``
(float32 products summed in other orders), the auxiliary terms to 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
ARCHS = ["deepseek-moe-16b", "qwen2-moe-a2.7b"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _moe(arch, dtype="float32", **moe_kw):
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    mod = tmoe.MoE(cfg, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _flat(jp).items()}, strict=True)
    return jcfg, jp, cfg, mod


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s", [(2, 8), (1, 256), (4, 100), (2, 300)], ids=["dense8", "dense256", "capacity400", "capacity600"])
def test_moe_apply_matches_jax(arch, b, s):
    jcfg, jp, cfg, mod = _moe(arch)
    x = _x(b, s, cfg.d_model, seed=b * s)
    jy, jaux = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg))(jp, x)
    ty, taux = tmoe.moe_apply(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(taux) == set(jaux) == {"load_balance_loss", "dropped_fraction"}
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=1e-6, rtol=1e-6)
    if b * s > tmoe.DENSE_PATH_MAX_TOKENS:
        assert float(taux["dropped_fraction"]) > 0  # the capacity path really dropped
    assert tmoe.moe_apply(mod, torch.from_numpy(x), cfg, return_aux=False)[1] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_path_equals_the_dense_path_when_nothing_drops(arch):
    """The sorted dispatch's gates are permuted into sorted order: with a
    no-drop capacity factor it agrees with the dense path token for token."""
    _, _, cfg, mod = _moe(arch, capacity_factor=16.0)
    x = torch.from_numpy(_x(2, 256, cfg.d_model, seed=2))  # 512 tokens: the capacity path
    y, aux = tmoe.moe_apply(mod, x, cfg)
    assert float(aux["dropped_fraction"]) == 0.0
    dense = torch.cat([tmoe.moe_apply(mod, x[i:i + 1], cfg)[0] for i in range(2)])  # 256 tokens each
    np.testing.assert_allclose(y.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_identical_tokens_give_identical_outputs(arch):
    _, _, cfg, mod = _moe(arch, capacity_factor=16.0)
    row = _x(1, 1, cfg.d_model, seed=4)
    x = torch.from_numpy(np.concatenate([_x(1, 300, cfg.d_model, seed=5), np.repeat(row, 60, 1)], 1))
    y, _ = tmoe.moe_apply(mod, x, cfg)
    assert torch.equal(y[0, 300:], y[0, 300:301].expand(60, -1))


def test_padded_experts_are_zero_and_never_routed():
    jcfg, jp, cfg, mod = _moe("qwen2-moe-a2.7b")
    e, e_pad = cfg.moe.num_experts, cfg.moe.num_experts_padded
    assert (e, e_pad) == (6, 16) and mod.router.shape == (cfg.d_model, e)
    assert not mod.wi[e:].any() and not mod.wo[e:].any()
    gen = torch.Generator().manual_seed(0)
    drawn = tmoe.moe_init(tmoe.MoE(cfg, device="cpu"), cfg, gen)
    assert not drawn.wi[e:].any() and not drawn.wo[e:].any() and drawn.wi[:e].any()


def test_router_stays_float32_in_a_bfloat16_model():
    jcfg, jp, cfg, mod = _moe("deepseek-moe-16b", dtype="bfloat16")
    assert mod.router.dtype == torch.float32 and mod.wi.dtype == torch.bfloat16
    assert mod.shared.wi.dtype == torch.bfloat16
    x = _x(2, 150, cfg.d_model, seed=8)  # 300 tokens: the capacity path
    jy = np.asarray(jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg))(jp, jnp.asarray(x, jnp.bfloat16))[0], np.float32)
    ty, _ = tmoe.moe_apply(mod, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert ty.dtype == torch.bfloat16
    # bf16 rounding at other points: within 2**-5 of the largest |output|
    np.testing.assert_allclose(ty.float().numpy(), jy, atol=2**-5 * np.abs(jy).max(), rtol=0)
