"""The MoE, Mamba and RG-LRU model families of the port against the JAX package's.

Smoke configs of deepseek-moe-16b (a leading dense layer, then MoE layers),
qwen2-moe-a2.7b (QKV bias, 6 experts padded to 16), falcon-mamba-7b (Mamba
layers, no attention) and recurrentgemma-9b (two ``(recurrent, recurrent,
local)`` patterns, window 32, tied and scaled embeddings), on the CPU. The
weights come from the JAX init and are carried across with
``convert.lm_params_from_numpy``; token ids are made with numpy from a
seed.

Tolerances, float32: both packages compute every product in float32 but
sum in other orders, so logits (magnitudes up to ~65) are held to
``atol=2e-4, rtol=1e-5`` and cache entries to ``atol=rtol=2e-5``, as the
dense family's tests hold them; the MoE aux terms to 1e-5. Greedy token
ids must be equal. bfloat16: logits within ``2**-4 · max|logit|`` (each
package rounds activations to bfloat16 at other points).
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import llm_demo as jdemo  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import llm_demo as tdemo  # noqa: E402

ARCHS = ["deepseek-moe-16b", "qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-9b"]
LOGIT_TOL = dict(atol=2e-4, rtol=1e-5)
CACHE_TOL = dict(atol=2e-5, rtol=2e-5)
PROMPT = 40  # past recurrentgemma-smoke's window of 32: the local ring buffer wraps


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(j_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


_JAX_PARAMS = {}


def _models(arch, **kw):
    """(jax cfg, jax params, port cfg, port params) with one set of weights."""
    jcfg, cfg = _cfgs(arch, **kw)
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = jax.jit(JModel(_cfgs(arch)[0]).init)(jax.random.PRNGKey(0))
    jp = _JAX_PARAMS[arch]
    return jcfg, jp, cfg, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _jax_cache_layers(jcfg, cache):
    """The JAX cache as one dict per layer, in layer order."""
    _, nb, pat, _ = jtr._plan(jcfg)
    return (list(cache["pre"])
            + [jax.tree.map(lambda a: a[b], cache["blocks"][pos]) for b in range(nb) for pos in range(len(pat))]
            + list(cache["tail"]))


def _check_caches(tc, jc, jcfg):
    jl = _jax_cache_layers(jcfg, jc)
    assert len(tc) == len(jl) == jcfg.num_layers
    for i, (t, j) in enumerate(zip(tc, jl)):
        flat_t = {f"{a}.{b}": v for a, d in t.items() for b, v in d.items()}
        flat_j = {f"{a}.{b}": v for a, d in j.items() for b, v in d.items()}
        assert flat_t.keys() == flat_j.keys(), i
        for name, v in flat_t.items():
            assert tuple(v.shape) == flat_j[name].shape, (i, name)
            np.testing.assert_allclose(_f32(v), _f32(flat_j[name]), **CACHE_TOL, err_msg=f"layer {i} {name}")


def test_the_layers_are_the_reference_plan():
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        params = ttr.init_params(cfg, 0, device="cpu")
        pre, _, _, _ = ttr._plan(cfg)
        kinds = [b.kind for b in params.layers]
        assert kinds == list(cfg.layer_kinds())
        for i, b in enumerate(params.layers):
            if b.kind == "ssm":
                assert not hasattr(b, "mlp") and not hasattr(b, "moe") and not hasattr(b, "ln2")
            elif cfg.moe is not None:
                assert hasattr(b, "mlp") == (i < len(pre)) and hasattr(b, "moe") == (i >= len(pre))
        if cfg.moe and cfg.moe.first_dense_layers:
            assert params.layers[0].mlp.wo.shape == (cfg.moe.first_dense_ff, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, jp, cfg, params = _models(arch)
    toks = _tokens(cfg, 2, PROMPT)
    jl, jaux = jax.jit(lambda p, t: jtr.forward(jcfg, p, t))(jp, toks)
    tl, taux = ttr.forward(cfg, params, torch.from_numpy(toks))
    assert tl.shape == (2, PROMPT, cfg.vocab_padded)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """prefill's last logits and cache, then 6 decode steps on JAX's greedy tokens."""
    jcfg, jp, cfg, params = _models(arch, attn_impl="pallas")
    toks = _tokens(cfg, 2, PROMPT)
    max_len = PROMPT + 7
    jl, jc = jax.jit(lambda p, t: jtr.prefill(jcfg, p, t, max_len))(jp, toks)
    tl, tc = ttr.prefill(cfg, params, torch.from_numpy(toks), max_len)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
    _check_caches(tc, jc, jcfg)
    decode = jax.jit(lambda c, tok, pos: jtr.decode_step(jcfg, jp, c, tok, pos))
    tok = np.argmax(_f32(jl)[:, 0, : cfg.vocab_size], -1).astype(np.int32)[:, None]
    for t in range(6):
        jl, jc = decode(jc, tok, np.int32(PROMPT + t))
        tl, tc = ttr.decode_step(cfg, params, tc, torch.from_numpy(tok), PROMPT + t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
        tok = np.argmax(_f32(jl)[:, 0, : cfg.vocab_size], -1).astype(np.int32)[:, None]
        assert np.array_equal(tok, tl[:, 0, : cfg.vocab_size].argmax(-1, keepdim=True).numpy())
    _check_caches(tc, jc, jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_long_prefill_matches_jax(arch):
    """2 × 140 tokens: the MoE capacity path, a Mamba chunk boundary, a wrapped ring."""
    jcfg, jp, cfg, params = _models(arch)
    toks = _tokens(cfg, 2, 140, seed=3)
    jl, jc = jax.jit(lambda p, t: jtr.prefill(jcfg, p, t, 150))(jp, toks)
    tl, tc = ttr.prefill(cfg, params, torch.from_numpy(toks), 150)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
    _check_caches(tc, jc, jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_gives_forward_logits(arch):
    """The port alone: 24 prompt tokens, then 8 teacher-forced decode steps,
    against one forward pass over all 32 (T ≤ 256: the MoE's dropless path)."""
    _, _, cfg, params = _models(arch)
    toks = torch.from_numpy(_tokens(cfg, 2, 32, seed=4))
    want, _ = ttr.forward(cfg, params, toks)
    got, cache = ttr.prefill(cfg, params, toks[:, :24], 33)
    steps = [got]
    for p in range(24, 31):
        lg, cache = ttr.decode_step(cfg, params, cache, toks[:, p:p + 1], p)
        steps.append(lg)
    got = torch.cat(steps, 1)
    np.testing.assert_allclose(got.numpy(), want[:, 23:31].numpy(), atol=1e-4 * float(want.abs().max()), rtol=0)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "recurrentgemma-9b"])
def test_forward_bfloat16_matches_jax(arch):
    jcfg, jp, cfg, params = _models(arch, dtype="bfloat16")
    assert params.embed.dtype == torch.bfloat16
    toks = _tokens(cfg, 2, PROMPT)
    jl, _ = jax.jit(lambda p, t: jtr.forward(jcfg, p, t))(jp, toks)
    tl, _ = ttr.forward(cfg, params, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    want = _f32(jl)
    np.testing.assert_allclose(_f32(tl), want, atol=2**-4 * np.abs(want).max(), rtol=0)


def _requests(cfg, module):
    """Four requests in two buckets (prompt lengths 40 and 12)."""
    rng = np.random.default_rng(7)
    return [module.Request(i, rng.integers(0, cfg.vocab_size, PROMPT if i < 2 else 12).tolist(),
                           max_new_tokens=6) for i in range(4)]


def _serve(engine, requests):
    for r in requests:
        engine.submit(r)
    return engine.run()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_matches_jax(arch):
    jcfg, jp, cfg, params = _models(arch, attn_impl="pallas")
    got = _serve(tdemo.ServeEngine(cfg, params, max_batch=8), _requests(cfg, tdemo))
    want = _serve(jdemo.ServeEngine(jcfg, jp, max_batch=8), _requests(cfg, jdemo))
    assert got == want and all(len(v) == 6 for v in got.values())
