"""The Mamba and RG-LRU blocks of the port against the JAX package's, on the CPU.

Smoke configs (falcon-mamba-7b, recurrentgemma-9b), float32, weights from
the JAX init carried across by name; inputs from numpy seeds.

Tolerances: both packages compute in float32 and sum matrix products in
other orders, so block outputs (magnitudes up to ~10) are held to
``atol=rtol=2e-5`` and states to the same. The associative scan has the
reference's fold tree, so on decays in [0.9, 1) it is bitwise JAX's
(eager; jitted, XLA contracts a multiply-add into an FMA). A
decode step by step is held against the port's own full pass within
``2e-5`` (they fold the recurrence in other trees), and a float32 decay is
never a product over a chunk: decays of ``exp(-1.6)`` a step stay finite
and nonzero over 300 steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.scan import associative_scan  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
LENGTHS = [9, 128, 131, 300]  # 131 and 300 cross a 128-step chunk boundary


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def _load(module, tree):
    """A port module holding the weights of a JAX parameter dict (same names)."""
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in tree.items()}, strict=True)
    return module


def _mamba(dtype="float32"):
    jcfg, cfg = _cfgs("falcon-mamba-7b", dtype)
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, _load(tssm.Mamba(cfg, device="cpu"), jp)


def _rglru(dtype="float32"):
    jcfg, cfg = _cfgs("recurrentgemma-9b", dtype)
    jp = jrg.rglru_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, _load(trg.RGLRU(cfg, device="cpu"), jp)


def _input(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _comb(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


@pytest.mark.parametrize("n", [1, 2, 3, 7, 130])
def test_associative_scan_is_bitwise_jax(n):
    """Eager JAX (under jit XLA fuses ``bl·ar + br`` into an FMA, the port does not)."""
    rng = np.random.default_rng(n)
    a = (0.9 + 0.1 * rng.random((2, n, 5))).astype(np.float32)
    b = rng.standard_normal((2, n, 5)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(_comb, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = associative_scan(_comb, (torch.from_numpy(a), torch.from_numpy(b)), axis=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 7, 6), (4, 6), (6,)))
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state else None
    jo, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               state=None if st is None else jnp.asarray(st))
    to, ts = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               state=None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("s", LENGTHS)
def test_mamba_apply_matches_jax(s):
    jcfg, jp, cfg, mod = _mamba()
    u = _input(2, s, cfg.d_model, seed=s)
    jy, jst = jax.jit(lambda p, x: jssm.mamba_apply(p, x, jcfg, return_state=True))(jp, u)
    ty, tst = tssm.mamba_apply(mod, torch.from_numpy(u), cfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("conv", "ssm"):
        assert tst[k].dtype == (torch.float32)
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)


def test_mamba_decode_step_by_step_equals_the_full_pass_and_jax():
    jcfg, jp, cfg, mod = _mamba()
    b, s = 2, 131
    u = _input(b, s, cfg.d_model, seed=5)
    full, fstate = tssm.mamba_apply(mod, torch.from_numpy(u), cfg, return_state=True)
    state = tssm.init_mamba_state(cfg, b, torch.float32, device="cpu")
    jstate = jssm.init_mamba_state(jcfg, b, jnp.float32)
    jdec = jax.jit(lambda st, x: jssm.mamba_decode(jp, x, st, jcfg))
    outs = []
    for t in range(s):
        y, state = tssm.mamba_decode(mod, torch.from_numpy(u[:, t:t + 1]), state, cfg)
        jy, jstate = jdec(jstate, jnp.asarray(u[:, t:t + 1]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(state[k].numpy(), fstate[k].numpy(), **TOL)
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), **TOL)


def test_mamba_decays_do_not_underflow_over_long_chunks():
    """Per-step decays of exp(-1.6): the state stays finite and nonzero."""
    _, _, cfg, mod = _mamba()
    with torch.no_grad():
        mod.A_log.fill_(np.log(16.0))  # A = -16; with dt ≈ 0.1, decay ≈ exp(-1.6)
    u = _input(1, 300, cfg.d_model, seed=9)
    y, st = tssm.mamba_apply(mod, torch.from_numpy(u), cfg, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(st["ssm"]).all() and st["ssm"].abs().max() > 0


@pytest.mark.parametrize("s", LENGTHS)
def test_rglru_apply_matches_jax(s):
    jcfg, jp, cfg, mod = _rglru()
    u = _input(2, s, cfg.d_model, seed=s + 1)
    jy, jst = jax.jit(lambda p, x: jrg.rglru_apply(p, x, jcfg, return_state=True))(jp, u)
    ty, tst = trg.rglru_apply(mod, torch.from_numpy(u), cfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)


def test_rglru_decode_step_by_step_equals_the_full_pass_and_jax():
    jcfg, jp, cfg, mod = _rglru()
    b, s = 2, 40
    u = _input(b, s, cfg.d_model, seed=3)
    full, fstate = trg.rglru_apply(mod, torch.from_numpy(u), cfg, return_state=True)
    state = trg.init_rglru_state(cfg, b, torch.float32, device="cpu")
    jstate = jrg.init_rglru_state(jcfg, b, jnp.float32)
    jdec = jax.jit(lambda st, x: jrg.rglru_decode(jp, x, st, jcfg))
    outs = []
    for t in range(s):
        y, state = trg.rglru_decode(mod, torch.from_numpy(u[:, t:t + 1]), state, cfg)
        jy, jstate = jdec(jstate, jnp.asarray(u[:, t:t + 1]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(state[k].numpy(), fstate[k].numpy(), **TOL)
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), **TOL)


def test_rglru_decay_in_unit_interval():
    _, _, cfg, mod = _rglru()
    x = torch.from_numpy(_input(1, 5, cfg.rglru.lru_width))
    a, _ = trg._gates(mod, x)
    assert bool(((a > 0) & (a < 1)).all())


def test_float32_parameters_stay_float32_in_bfloat16_models():
    """What the reference reads in float32 is stored in float32; the rest in bf16."""
    _, _, _, mamba = _mamba("bfloat16")
    _, _, _, rec = _rglru("bfloat16")
    f32 = {"A_log", "D", "wa", "ba", "wx", "bx", "lambda"}
    for mod in (mamba, rec):
        for name, p in mod.named_parameters():
            assert p.dtype == (torch.float32 if name in f32 else torch.bfloat16), name


@pytest.mark.parametrize("block", ["mamba", "rglru"])
def test_bfloat16_blocks_match_jax(block):
    """bf16 activations: within 2**-5 of the largest |output| (a few bf16 ulps)."""
    jcfg, jp, cfg, mod = _mamba("bfloat16") if block == "mamba" else _rglru("bfloat16")
    jmod, tmod = (jssm.mamba_apply, tssm.mamba_apply) if block == "mamba" else (jrg.rglru_apply, trg.rglru_apply)
    u = _input(2, 131, cfg.d_model, seed=11)
    jy = np.asarray(jax.jit(lambda p, x: jmod(p, x, jcfg))(jp, jnp.asarray(u, jnp.bfloat16)), np.float32)
    ty = tmod(mod, torch.from_numpy(u).to(torch.bfloat16), cfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), jy, atol=2**-5 * np.abs(jy).max(), rtol=0)
