"""The LM serving path of the port against the JAX package's, on the CPU.

Dense family at smoke size: gemma-2b (MQA, GeGLU, head 256 at full width),
gemma2-9b (local/global layers with a ring-buffer cache, attention and
final softcaps, post-norms), codeqwen1.5-7b and qwen2.5-14b (QKV bias,
untied head, SwiGLU). The weights come from the JAX init and are carried
across with ``convert.lm_params_from_numpy``; token ids are made with numpy
from a seed and given to both packages.

Tolerances, float32 (``dtype="float32"``): both packages compute every
matrix product in float32 but sum in other orders (XLA's CPU dots against
PyTorch's), so values agree to a few float32 ulps per op; over 3-4 layers
and the head the logits (magnitudes up to ~45) differed by at most 2e-5,
so logits are held to ``atol=2e-4, rtol=1e-5`` and single layers to
``atol=rtol=2e-5`` (``1e-6`` for the norm and RoPE, which are elementwise).
Greedy token ids must be equal. bfloat16: each package rounds activations
to bfloat16 at slightly different points (PyTorch's GELU and SiLU compute
in float32 and round once), so logits differed by up to one bfloat16 ulp
of the largest logit; they are held within four such ulps,
``atol = 2**-5 · max|logit|``.
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

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import llm_demo as jdemo  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import llm_demo as tdemo  # noqa: E402

ARCHS = ["gemma-2b", "gemma2-9b", "codeqwen1.5-7b", "qwen2.5-14b"]
LOGIT_TOL = dict(atol=2e-4, rtol=1e-5)
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
PROMPT = 20  # longer than gemma2-9b-smoke's window of 16: the ring buffer wraps


def _cfgs(arch, **kw):
    """The same smoke config in both packages, with ``kw`` replaced."""
    kw.setdefault("dtype", "float32")
    return (
        dataclasses.replace(j_get_config(arch, smoke=True), **kw),
        dataclasses.replace(get_config(arch, smoke=True), **kw),
    )


_JAX_PARAMS = {}


def _jax_params(arch):
    if arch not in _JAX_PARAMS:
        jcfg, _ = _cfgs(arch)
        # jitted: the same values as the eager init, in half the time
        _JAX_PARAMS[arch] = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))
    return _JAX_PARAMS[arch]


def _models(arch, **kw):
    """(jax cfg, jax params, port cfg, port params) with one set of weights."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp = _jax_params(arch)
    return jcfg, jp, cfg, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _layer_tree(jcfg, jp, i):
    """Layer ``i`` of the JAX tree (its scanned stacks sliced)."""
    _, _, pat, _ = jtr._plan(jcfg)
    b, pos = divmod(i, len(pat))
    return jax.tree.map(lambda a: a[b], jp["blocks"][pos])


def _jax_cache_layers(jcfg, cache):
    _, nb, pat, _ = jtr._plan(jcfg)
    return [
        jax.tree.map(lambda a: a[b], cache["blocks"][pos])
        for b in range(nb) for pos in range(len(pat))
    ]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
LAYER_DTYPES = {
    "float32": (jnp.float32, torch.float32, dict(atol=1e-6, rtol=1e-6)),
    # one bfloat16 ulp (2**-8 relative) either way of a float32 result
    "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=1e-2, rtol=2**-7)),
}


@pytest.mark.parametrize("dtype", LAYER_DTYPES)
def test_rmsnorm_matches_jax(dtype):
    jdt, tdt, tol = LAYER_DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 4).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jdt))
    got = tlayers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("batched_positions", [False, True])
@pytest.mark.parametrize("dtype", LAYER_DTYPES)
def test_rope_matches_jax(dtype, batched_positions):
    jdt, tdt, tol = LAYER_DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7) + 100
    if batched_positions:
        pos = np.stack([pos, pos + 5]).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x, jdt), jnp.asarray(pos), 10_000.0)
    got = tlayers.rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 10_000.0)
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), **(tol if dtype == "bfloat16" else LAYER_TOL))


@pytest.mark.parametrize("dtype", LAYER_DTYPES)
@pytest.mark.parametrize("activation", ["gelu", "silu", "gelu_plain"])
def test_mlp_matches_jax(activation, dtype):
    jdt, tdt, _ = LAYER_DTYPES[dtype]
    p = jlayers.mlp_init(jax.random.PRNGKey(3), 32, 48, activation)
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    want = jlayers.mlp_apply(p, jnp.asarray(x, jdt), activation)
    wi, wo = (torch.from_numpy(np.array(p[k])).to(tdt) for k in ("wi", "wo"))
    got = tlayers.mlp_apply(wi, wo, torch.from_numpy(x).to(tdt), activation)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), **LAYER_TOL)
    else:  # rounding points differ (see the module docstring)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2**-5 * np.abs(_f32(want)).max(), rtol=0)


# ---------------------------------------------------------------------------
# Attention, forward, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_apply_matches_jax(arch, impl):
    # attn_chunk=8: the chunked path takes three chunks of a 20-token prompt
    jcfg, jp, cfg, params = _models(arch, attn_impl=impl, attn_chunk=8)
    x = np.random.default_rng(4).standard_normal((2, PROMPT, cfg.d_model)).astype(np.float32)
    pos = np.arange(PROMPT)
    for i, kind in enumerate(cfg.pattern):  # one layer of each kind
        jy, (jk, jv) = jattn.attn_apply(
            _layer_tree(jcfg, jp, i)["attn"], jnp.asarray(x), jcfg, jnp.asarray(pos), kind=kind
        )
        ty, (tk, tv) = tattn.attn_apply(
            params.layers[i].attn, torch.from_numpy(x), cfg, torch.from_numpy(pos), kind=kind
        )
        np.testing.assert_allclose(_f32(ty), _f32(jy), **LAYER_TOL)
        np.testing.assert_allclose(_f32(tk), _f32(jk), **LAYER_TOL)
        np.testing.assert_allclose(_f32(tv), _f32(jv), **LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, jp, cfg, params = _models(arch)
    toks = _tokens(cfg, 2, PROMPT)
    jl, _ = jtr.forward(jcfg, jp, jnp.asarray(toks))
    tl, aux = ttr.forward(cfg, params, torch.from_numpy(toks))
    assert aux == {} and tl.shape == (2, PROMPT, cfg.vocab_padded)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)


def test_forward_logits_bfloat16_match_jax():
    jcfg, jp, cfg, params = _models("gemma-2b", dtype="bfloat16")
    assert params.embed.dtype == torch.bfloat16 and params.final_norm.scale.dtype == torch.float32
    toks = _tokens(cfg, 2, PROMPT)
    jl, _ = jtr.forward(jcfg, jp, jnp.asarray(toks))
    tl, _ = ttr.forward(cfg, params, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    want = _f32(jl)
    np.testing.assert_allclose(_f32(tl), want, atol=2**-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """prefill's last logits and cache, then 8 decode steps on JAX's greedy tokens."""
    jcfg, jp, cfg, params = _models(arch, attn_impl="pallas")
    toks = _tokens(cfg, 2, PROMPT)
    max_len = PROMPT + 9
    jl, jc = jtr.prefill(jcfg, jp, jnp.asarray(toks), max_len)
    tl, tc = ttr.prefill(cfg, params, torch.from_numpy(toks), max_len)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
    jlayers_c = _jax_cache_layers(jcfg, jc)
    assert len(tc) == len(jlayers_c) == cfg.num_layers
    for i, (t, j) in enumerate(zip(tc, jlayers_c)):
        for name in ("k", "v"):
            assert t["kv"][name].shape == j["kv"][name].shape, (i, name)
            np.testing.assert_allclose(_f32(t["kv"][name]), _f32(j["kv"][name]), **LAYER_TOL)
    decode = jax.jit(lambda c, tok, pos: jtr.decode_step(jcfg, jp, c, tok, pos))
    tok = np.argmax(_f32(jl)[:, 0, : cfg.vocab_size], -1).astype(np.int32)[:, None]
    for t in range(8):
        jl, jc = decode(jc, jnp.asarray(tok), jnp.int32(PROMPT + t))
        tl, tc = ttr.decode_step(cfg, params, tc, torch.from_numpy(tok), PROMPT + t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
        tok = np.argmax(_f32(jl)[:, 0, : cfg.vocab_size], -1).astype(np.int32)[:, None]
        assert np.array_equal(tok, tl[:, 0, : cfg.vocab_size].argmax(-1, keepdim=True).numpy())
    for t, j in zip(tc, _jax_cache_layers(jcfg, jc)):
        np.testing.assert_allclose(_f32(t["kv"]["k"]), _f32(j["kv"]["k"]), **LAYER_TOL)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _requests(cfg, module, eos_id=None):
    """Five requests in two buckets (prompt lengths 20 and 12); request 0 stops at eos_id."""
    rng = np.random.default_rng(7)
    return [
        module.Request(
            i, rng.integers(0, cfg.vocab_size, PROMPT if i < 3 else 12).tolist(),
            max_new_tokens=8, eos_id=eos_id if i == 0 else None,
        )
        for i in range(5)
    ]


def _serve(engine, requests):
    for r in requests:
        engine.submit(r)
    return engine.run()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_matches_jax(arch):
    jcfg, jp, cfg, params = _models(arch, attn_impl="pallas")
    full = _serve(tdemo.ServeEngine(cfg, params, max_batch=8), _requests(cfg, tdemo))
    eos = full[0][2]  # request 0 stops at its third token (or earlier)
    engine = tdemo.ServeEngine(cfg, params, max_batch=8)
    got = _serve(engine, _requests(cfg, tdemo, eos_id=eos))
    want = _serve(jdemo.ServeEngine(jcfg, jp, max_batch=8), _requests(cfg, jdemo, eos_id=eos))
    assert got == want
    assert got[0] == full[0][: full[0].index(eos) + 1] and len(got[0]) <= 3
    assert all(got[i] == full[i] and len(got[i]) == 8 for i in range(1, 5))
    assert [(s["batch"], s["prompt_len"]) for s in engine.stats] == [(3, PROMPT), (2, 12)]


def test_sampling_stays_in_top_k_and_repeats_with_the_seed():
    _, _, cfg, params = _models("gemma-2b")

    def run(seed):
        eng = tdemo.ServeEngine(cfg, params, max_batch=8, seed=seed)
        reqs = _requests(cfg, tdemo)
        for r in reqs:
            r.temperature, r.top_k = 1.0, 4
        return _serve(eng, reqs)

    assert run(3) == run(3)
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    toks = torch.stack([tdemo.sample_token(logits, gen, 0.7, 5) for _ in range(20)])
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert (toks[..., None] == top5[None]).any(-1).all()
    assert torch.equal(tdemo.sample_token(logits, gen, 0.0, 0), logits.argmax(-1))


def test_serve_launcher_runs_on_the_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b", "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"request {i}" for i in range(3)]
    assert all(len(eval(ln.split(":", 1)[1])) == 4 for ln in lines)


@pytest.mark.parametrize(
    "arch",
    ["deepseek-moe-16b", "qwen2-moe-a2.7b", "recurrentgemma-9b", "falcon-mamba-7b",
     "whisper-medium", "internvl2-26b"],
)
def test_families_not_ported_raise(arch):
    """Every family is ported and builds and runs: the MoE, RG-LRU and Mamba
    families (ROADMAP A13 item 1), and whisper (with its stub frames) and
    internvl2 (with its patch embeddings; A13 item 2). Nothing raises
    ``NotImplementedError`` any more."""
    cfg = get_config(arch, smoke=True)
    params = ttr.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    extra = {}
    if cfg.is_enc_dec:
        extra["frames"] = torch.from_numpy(
            rng.standard_normal((1, cfg.encdec.encoder_frames, cfg.d_model)).astype(np.float32))
    if cfg.vision is not None:
        extra["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((1, cfg.vision.num_patches, cfg.d_model)).astype(np.float32))
    logits, _ = ttr.forward(cfg, params, torch.from_numpy(_tokens(cfg, 1, 8)), **extra)
    n = 8 + (cfg.vision.num_patches if cfg.vision is not None else 0)
    assert logits.shape == (1, n, cfg.vocab_padded) and bool(torch.isfinite(logits).all())
