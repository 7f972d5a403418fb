"""Training in the port (optim/, data/, train/, checkpoint/, launch/train)
against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages: parameters from the
JAX init carried over with ``convert.lm_params_from_numpy(...,
master_weights=True)``, token batches from ``SyntheticLM`` or numpy,
gradients for the optimizers from numpy.

Tolerances, float32 (``dtype="float32"``, so the compute cast is the
identity): both packages compute in float32 but sum in other orders.
Optimizer updates, schedules and clipping are elementwise or one reduction:
``rtol=atol=1e-6`` (Adafactor's factored second moment: 2e-6). The chunked
cross-entropy and the loss of ``make_loss_fn``: ``rtol=1e-6``, gradients
``atol=1e-6·max|g| + 1e-7, rtol=1e-4`` (a few float32 ulps of the largest
gradient over a few layers of sums). Two steps of ``make_train_step``
(AdamW, lr 1e-3, clipping) move every parameter by up to 2e-3. AdamW's
step ĝ/√v̂ is scale-free, so a gradient entry that cancels to near zero,
whose relative error is far above a float32 ulp, can move its step by a
few per cent of lr: the updated parameters are held to ``atol=5e-5``
(float32 accumulation) and, with the bfloat16 accumulation of
``grad_sync="compressed_bf16"`` (a gradient rounded to bfloat16 on the
other side of a rounding boundary), to ``atol=2e-4``.
``SyntheticLM`` batches and checkpoint arrays must be bitwise equal; the
port's loop interrupted and resumed must give the uninterrupted run's bits.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data import SyntheticLMConfig as JSyntheticLMConfig  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402

from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy, lm_tree_ndims  # noqa: E402
from repro_torch.data import SyntheticLM, SyntheticLMConfig, batches  # noqa: E402
from repro_torch.kernels.ops import attention  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.reliability.faults import FailureInjector  # noqa: E402
from repro_torch.train import (  # noqa: E402
    abstract_train_state,
    chunked_cross_entropy,
    make_loss_fn,
    make_train_state,
    make_train_step,
)
from repro_torch.train import state as tstate  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
FAMILIES = ["gemma-2b", "deepseek-moe-16b", "falcon-mamba-7b", "recurrentgemma-9b",
            "whisper-medium", "internvl2-26b"]


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(j_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


_JAX_PARAMS = {}


def _jax_params(arch):
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = jax.jit(JModel(_cfgs(arch)[0]).init)(jax.random.PRNGKey(0))
    return _JAX_PARAMS[arch]


def _models(arch, **kw):
    """(jax cfg, jax params, port cfg, port master params) with one set of weights."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp = _jax_params(arch)
    tp = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu", master_weights=True)
    return jcfg, jp, cfg, tp


def _batch(cfg, b=2, s=12, seed=3):
    """Tokens, labels (a few -1), and the stub inputs the config takes, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    out["labels"][0, -2:] = -1
    if cfg.vision is not None:
        out["patch_embeds"] = rng.standard_normal((b, cfg.vision.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal((b, cfg.encdec.encoder_frames, cfg.d_model)).astype(np.float32)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got_tree, want_tree, **tol):
    gl, gdef = jax.tree_util.tree_flatten(got_tree)
    wl, wdef = jax.tree_util.tree_flatten(want_tree)
    assert gdef == wdef
    for i, (g, w) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=f"leaf {i}", **tol)


def _grad_tol(want_tree):
    top = max(float(np.abs(_f32(w)).max()) for w in jax.tree.leaves(want_tree))
    return dict(atol=1e-6 * top + 1e-7, rtol=1e-4)


# ---------------------------------------------------------------------------
# optim/
# ---------------------------------------------------------------------------
SHAPES = {"w": (6, 5), "stack": (2, 4, 3), "b": (7,), "s": ()}


def _opt_inputs(steps=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _run_both(jopt, topt, steps=4):
    params, grads = _opt_inputs(steps)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        out, ts2 = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert out is tp and ts2 is ts  # in place
    return jp, js, tp, ts


@pytest.mark.parametrize("kind", ["plain", "weight_decay", "schedule"])
def test_adamw_matches_jax(kind):
    kw = {"weight_decay": 0.1} if kind != "plain" else {}
    jkw, tkw = dict(kw), dict(kw)
    if kind == "schedule":
        jkw["learning_rate"] = joptim.cosine_with_warmup(1e-2, 2, 6)
        tkw["learning_rate"] = toptim.cosine_with_warmup(1e-2, 2, 6)
    jp, js, tp, ts = _run_both(joptim.AdamW(**jkw), toptim.AdamW(**tkw))
    for k in SHAPES:
        np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), **OPT_TOL, err_msg=k)
        np.testing.assert_allclose(_f32(ts["mu"][k]), _f32(js["mu"][k]), **OPT_TOL)
        np.testing.assert_allclose(_f32(ts["nu"][k]), _f32(js["nu"][k]), **OPT_TOL)
    assert int(ts["count"]) == int(js["count"]) == 4 and ts["count"].dtype == torch.int32
    assert all(ts["mu"][k].dtype == torch.float32 for k in SHAPES)


def test_adamw_moments_stay_float32_for_bf16_params():
    p = {"w": torch.ones((3, 4), dtype=torch.bfloat16)}
    opt = toptim.AdamW(learning_rate=0.1)
    st = opt.init(p)
    opt.update({"w": torch.full((3, 4), 0.5, dtype=torch.bfloat16)}, st, p)
    assert st["mu"]["w"].dtype == torch.float32 and p["w"].dtype == torch.bfloat16
    assert float(p["w"][0, 0]) == pytest.approx(0.90, abs=2**-7)


def test_adafactor_matches_jax():
    jp, js, tp, ts = _run_both(joptim.Adafactor(learning_rate=1e-2), toptim.Adafactor(learning_rate=1e-2))
    tol = dict(rtol=2e-6, atol=2e-6)
    for k in SHAPES:
        np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), err_msg=k, **tol)
        jacc, tacc = js["acc"][k], ts["acc"][k]
        assert set(jacc) == set(tacc)
        for f in jacc:
            assert tuple(tacc[f].shape) == jacc[f].shape
            np.testing.assert_allclose(_f32(tacc[f]), _f32(jacc[f]), err_msg=f"{k}.{f}", **tol)
    assert int(ts["count"]) == 4


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("linear_warmup", (1e-3, 5)), ("linear_warmup", (1e-3, 0)),
    ("cosine_with_warmup", (1e-3, 3, 10)), ("cosine_with_warmup", (2e-3, 0, 7, 0.0)),
])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for c in range(0, 14):
        want = jf(jnp.asarray(c, jnp.int32))
        got = tf(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12, err_msg=str(c))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clipping_matches_jax(max_norm):
    _, grads = _opt_inputs(1)
    g = grads[0]
    jg, jn = joptim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    tg, tn = toptim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
    np.testing.assert_allclose(float(toptim.global_norm(list(tg.values()))),
                               float(joptim.global_norm(jg)), **OPT_TOL)
    for k in g:
        np.testing.assert_allclose(_f32(tg[k]), _f32(jg[k]), **OPT_TOL)


def test_grad_compression_matches_jax():
    _, grads = _opt_inputs(1)
    g = grads[0]
    jc = joptim.compress_for_sync({k: jnp.asarray(v) for k, v in g.items()}, "compressed_bf16")
    tc = toptim.compress_for_sync({k: torch.from_numpy(v) for k, v in g.items()}, "compressed_bf16")
    for k in g:
        assert tc[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(tc[k]), _f32(jc[k]))
    back = toptim.decompress_after_sync(tc, "compressed_bf16")
    assert all(v.dtype == torch.float32 for v in back.values())
    assert toptim.compress_for_sync(g, "none") is g
    with pytest.raises(ValueError, match="unknown grad_sync"):
        toptim.compress_for_sync(g, "fp8")


# ---------------------------------------------------------------------------
# data/
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,host_id,num_hosts", [(0, 0, 0, 1), (3, 17, 0, 1), (5, 2, 1, 2)])
def test_synthetic_lm_batches_are_bitwise_the_reference(seed, step, host_id, num_hosts):
    kw = dict(vocab_size=300, seq_len=33, global_batch=4, seed=seed, host_id=host_id, num_hosts=num_hosts)
    want = JSyntheticLM(JSyntheticLMConfig(**kw)).batch(step)
    got = SyntheticLM(SyntheticLMConfig(**kw)).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = batches(300, 33, 4, seed=seed, start_step=step)
    np.testing.assert_array_equal(next(it)["tokens"], SyntheticLM(SyntheticLMConfig(300, 33, 4, seed=seed)).batch(step)["tokens"])


# ---------------------------------------------------------------------------
# train/
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_chunked_cross_entropy_matches_jax(softcap):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 300, 16)).astype(np.float32)  # 300: two chunks, the last padded
    head = (rng.standard_normal((40, 16)) * 0.5).astype(np.float32)
    y = rng.integers(0, 40, (2, 300)).astype(np.int32)
    y[1, 250:] = -1

    def jloss(h, head):
        return jstep.chunked_cross_entropy(h, head, y, softcap=softcap)[0]

    jl, (jgh, jghead) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(True)
    tl, cnt = chunked_cross_entropy(th, thead, torch.from_numpy(y), softcap=softcap)
    tl.backward()
    assert float(cnt) == 550
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for got, want in ((th.grad, jgh), (thead.grad, jghead)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_grad_tol(want))


def _jax_loss_and_grads(jcfg, jp, batch):
    loss_fn = jstep.make_loss_fn(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp, jb)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg, jp, cfg, tp = _models(arch)
    batch = _batch(cfg)
    (jl, jm), jg = _jax_loss_and_grads(jcfg, jp, batch)
    loss, metrics = make_loss_fn(cfg)(tp, _tb(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    grads = {n: p.grad for n, p in tp.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32 for g in grads.values())
    _assert_tree_close(lm_params_to_numpy(cfg, grads), jg, **_grad_tol(jg))


def test_bf16_compute_casts_once_and_sums_tied_cotangents_in_bf16():
    """bfloat16 compute over float32 masters: the loss and gradients within
    bfloat16 rounding of the reference's (each package rounds activations at
    slightly other points)."""
    jcfg, jp, cfg, tp = _models("gemma-2b", dtype="bfloat16")
    batch = _batch(cfg)
    (jl, _), jg = _jax_loss_and_grads(jcfg, jp, batch)
    loss, _ = make_loss_fn(cfg)(tp, _tb(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-2)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in tp.parameters())
    got = lm_params_to_numpy(cfg, {n: p.grad for n, p in tp.named_parameters()})
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jg)):
        w = _f32(w)
        assert np.abs(_f32(g) - w).max() <= 0.1 * np.abs(w).max() + 1e-6
    # The embedding's gradient is a bf16 sum cast once: every entry is a bfloat16 value.
    e = tp.embed.grad
    assert torch.equal(e, e.to(torch.bfloat16).float())


def test_compute_cast_follows_the_reference_tree():
    """≥ 2-D in the reference's tree (scanned layers stacked) is cast; the
    decay mask is the reference's default on that tree."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    params = Transformer(cfg, device="meta", master_weights=True)
    nd = lm_tree_ndims(cfg, params)
    assert nd["layers.0.ln1.scale"] == 1  # deepseek's leading dense layer: not scanned
    assert nd["layers.1.ln1.scale"] == 2 and nd["layers.1.attn.wq"] == 4
    assert nd["embed"] == 2 and nd["final_norm.scale"] == 1
    mask = tstate.decay_mask(cfg)(params)
    assert mask["layers.1.ln1.scale"] and not mask["layers.0.ln1.scale"] and not mask["final_norm.scale"]
    w = get_config("whisper-medium", smoke=True)
    assert lm_tree_ndims(w, Transformer(w, device="meta", master_weights=True))["encoder.blocks.0.ln1.scale"] == 2


def _jax_train(jcfg, jp, batches, **kw):
    """The JAX train state after a step on each batch, the metrics, and the step."""
    jopt = joptim.AdamW(learning_rate=1e-3, weight_decay=0.01)
    step = jax.jit(jstep.make_train_step(jcfg, jopt, **kw))
    st = JTrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    ms = []
    for b in batches:
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        ms.append(m)
    return st, ms, step


@pytest.mark.parametrize("grad_sync", ["none", "compressed_bf16"])
def test_train_step_with_accumulation_matches_jax(grad_sync):
    jcfg, jp, cfg, tp = _models("gemma-2b")
    bs = [_batch(cfg, b=4, s=10, seed=s) for s in (5, 6)]
    jst, jms, _ = _jax_train(jcfg, jp, bs, accum_steps=2, grad_sync=grad_sync)
    opt = toptim.AdamW(learning_rate=1e-3, weight_decay=0.01, decay_mask=tstate.decay_mask(cfg))
    st = {"params": tp, "opt_state": opt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(cfg, opt, accum_steps=2, grad_sync=grad_sync)
    for b, jm in zip(bs, jms):
        st2, m = step(st, _tb(b))
        assert st2 is st
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    assert int(st["step"]) == 2 and int(st["opt_state"]["count"]) == 2
    tol = dict(atol=5e-5 if grad_sync == "none" else 2e-4, rtol=0)
    _assert_tree_close(lm_params_to_numpy(cfg, st["params"]), jst["params"], **tol)
    _assert_tree_close(lm_params_to_numpy(cfg, st["opt_state"]["mu"]), jst["opt_state"]["mu"],
                       atol=2e-5 if grad_sync == "none" else 2e-3, rtol=1e-3)


def test_train_step_moe_metrics():
    """With MoE layers the step reports the aux terms, as the loss gives them."""
    _, _, cfg, tp = _models("qwen2-moe-a2.7b")
    b = _tb(_batch(cfg, b=2, s=8))
    _, want = make_loss_fn(cfg)(tp, b)
    opt = toptim.AdamW(learning_rate=1e-3)
    st = {"params": tp, "opt_state": opt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    _, m = make_train_step(cfg, opt)(st, b)
    assert {"load_balance_loss", "dropped_fraction", "grad_norm", "ce_loss", "tokens", "loss"} == set(m)
    for k in want:
        assert float(m[k]) == float(want[k]), k
    assert float(m["grad_norm"]) > 0


def test_b3_under_autograd_raises():
    q = torch.zeros((1, 2, 4, 8), requires_grad=True)
    k = v = torch.zeros((1, 2, 4, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        attention(q, k, v, use_kernel=True)
    with torch.no_grad():
        assert attention(q, k, v, use_kernel=True).shape == (1, 2, 4, 8)
    _, _, cfg, tp = _models("gemma-2b", attn_impl="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        make_loss_fn(cfg)(tp, _tb(_batch(cfg)))


def test_training_entry_points_without_a_device_raise_without_cuda(monkeypatch, tmp_path):
    """They run on the card by default and never fall back to the CPU."""
    cfg = get_config("gemma-2b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_state(cfg, toptim.AdamW(), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, _loop(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy(cfg, {}, master_weights=True)


def test_train_state_builders():
    cfg = get_config("internvl2-26b", smoke=True)
    opt = toptim.AdamW()
    st = make_train_state(cfg, opt, 0, device="cpu")
    ab = abstract_train_state(cfg, opt)
    for (n, p), (n2, a) in zip(st["params"].named_parameters(), ab["params"].named_parameters()):
        assert n == n2 and p.shape == a.shape and p.dtype == a.dtype == torch.float32 and a.is_meta
        assert p.requires_grad
    assert ab["step"].is_meta and ab["opt_state"]["mu"]["embed"].is_meta


# ---------------------------------------------------------------------------
# checkpoint/
# ---------------------------------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": [rng.standard_normal(3).astype(np.float32), None,
                  {"z": np.int32(seed), "a": rng.standard_normal((2, 2)).astype(np.float32)}],
            "a": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}


def test_checkpoint_round_trip_keep_n_and_async(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        m.save(s, _tree(s))  # async
    m.wait()
    assert m.all_steps() == [2, 3] and m.latest_step() == 3
    got, step = m.restore(_tree(0))
    assert step == 3
    want = _tree(3)
    np.testing.assert_array_equal(got["a"], want["a"].numpy())
    np.testing.assert_array_equal(got["b"][0], want["b"][0])
    np.testing.assert_array_equal(got["b"][2]["a"], want["b"][2]["a"])
    assert got["b"][1] is None and got["b"][2]["z"] == 3
    got2, step2 = m.restore(_tree(0), step=2)
    assert step2 == 2 and np.array_equal(got2["a"], _tree(2)["a"].numpy())
    # crash debris is swept by the next save
    os.makedirs(tmp_path / ".tmp_step_9")
    os.makedirs(tmp_path / "step_0000000007")  # no payload: never offered
    assert m.all_steps() == [2, 3]
    m.save(4, _tree(4), block=True)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000004"]


def test_latest_step_waits_for_a_save_in_flight(tmp_path, monkeypatch):
    """The port's fix of a race in the reference: a large async save still
    being written when the loop fails must be the step it restores."""
    import time as _time

    from repro_torch.checkpoint import manager as tmanager

    savez = np.savez

    def slow_savez(*a, **k):
        _time.sleep(0.5)
        return savez(*a, **k)

    monkeypatch.setattr(tmanager.np, "savez", slow_savez)
    m = CheckpointManager(str(tmp_path))
    m.save(3, _tree(3))
    assert m.latest_step() == 3
    ref = JCheckpointManager(str(tmp_path / "j"))
    monkeypatch.setattr(np, "savez", slow_savez)  # the same module object the reference's manager uses
    ref.save(3, {"a": np.zeros(2, np.float32)})
    assert ref.latest_step() is None  # the reference's race
    ref.wait()
    assert ref.latest_step() == 3


def test_checkpoint_mismatch_raises(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree(1), block=True)
    with pytest.raises(ValueError, match="architecture mismatch"):
        m.restore({"a": np.zeros(4, np.float32)})
    bad = _tree(0)
    bad["a"] = torch.zeros(5)
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore(bad)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_tree(0))


@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-medium"])
def test_jax_checkpoint_resumes_in_the_port_and_back(arch, tmp_path):
    jcfg, jp, cfg, _ = _models(arch)
    jst, _, jax_step = _jax_train(jcfg, jp, [_batch(cfg, seed=1)])
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(1, jst)
    opt = toptim.AdamW(learning_rate=1e-3, weight_decay=0.01, decay_mask=tstate.decay_mask(cfg))
    st = make_train_state(cfg, opt, 7, device="cpu")
    tree, step = CheckpointManager(str(tmp_path / "j")).restore(
        tstate.checkpoint_tree(cfg, abstract_train_state(cfg, opt)))
    tstate.load_checkpoint_tree(cfg, st, tree)
    assert step == 1 and int(st["step"]) == 1 and int(st["opt_state"]["count"]) == 1
    for got, want in ((st["params"], jst["params"]), (st["opt_state"]["mu"], jst["opt_state"]["mu"])):
        gl, wl = jax.tree.leaves(lm_params_to_numpy(cfg, got)), jax.tree.leaves(want)
        assert all(np.array_equal(g, np.asarray(w)) for g, w in zip(gl, wl))
    # one more step from the resumed state in both packages
    b = _batch(cfg, seed=9)
    jst2, _ = jax_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
    make_train_step(cfg, opt)(st, _tb(b))
    _assert_tree_close(lm_params_to_numpy(cfg, st["params"]), jst2["params"], atol=5e-5, rtol=0)
    # and the port's checkpoint restored by the JAX manager
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(2, tstate.checkpoint_tree(cfg, st))
    back, step = JCheckpointManager(str(tmp_path / "t")).restore(jst2)
    assert step == 2
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tstate.checkpoint_tree(cfg, st))):
        np.testing.assert_array_equal(np.asarray(g), _f32(w) if isinstance(w, torch.Tensor) else w)


# ---------------------------------------------------------------------------
# train() and the launcher
# ---------------------------------------------------------------------------
def _loop(tmp, **kw):
    base = dict(total_steps=12, checkpoint_every=4, checkpoint_dir=str(tmp), keep=2, seq_len=32,
                global_batch=4, learning_rate=3e-3, log_every=0)
    return TrainLoopConfig(**{**base, **kw})


def _params_bits(state):
    return {n: p.detach().clone() for n, p in state["params"].named_parameters()}


def test_train_loss_falls_and_interrupted_equals_uninterrupted(tmp_path):
    cfg = get_config("gemma-2b", smoke=True)
    full = train(cfg, _loop(tmp_path / "u"), device="cpu")
    assert full["final_step"] == 12 and full["recoveries"] == 0 and len(full["losses"]) == 12
    assert full["last_loss"] < full["first_loss"]
    # a failure at step 6 rolls back to the checkpoint at 4 and replays 4, 5
    hurt = train(cfg, _loop(tmp_path / "f", total_steps=8), failure_injector=FailureInjector((6,)), device="cpu")
    assert hurt["recoveries"] == 1 and hurt["final_step"] == 8
    assert hurt["losses"] == full["losses"][:6] + full["losses"][4:8]
    # a second run in the same directory resumes from step 8
    resumed = train(cfg, _loop(tmp_path / "f"), device="cpu")
    assert resumed["losses"] == full["losses"][8:]
    want, got = _params_bits(full["state"]), _params_bits(resumed["state"])
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert CheckpointManager(str(tmp_path / "f")).all_steps() == [8, 12]


def test_train_launcher_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2.5-14b", "--smoke",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq-len", "24",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("done: steps=3")
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002", "step_0000000003"]
