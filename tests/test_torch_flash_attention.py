"""Flash attention (B3) against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX package's
Pallas kernel (interpret mode off the TPU, as its own tests run it), its
oracle ``repro.kernels.ref.attention_ref``, and the port's
``flash_attention``, which on a CPU tensor is its plain version
(``flash_attention_ref``). Tolerances are the JAX tests' own bounds for the
Pallas kernel against ``attention_ref``: ``rtol = atol = 2e-5`` in float32
(the three sum in other orders) and ``3e-2`` in bfloat16 (each rounds its
output to bfloat16 from a float32 result that differs in the last bits).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.ref import attention_ref  # noqa: E402

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

j_ref = jax.jit(attention_ref, static_argnames=("causal", "window", "softcap", "scale"))
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
SHAPES = [
    (2, 4, 4, 64, 64, 32),  # MHA
    (1, 8, 2, 128, 128, 64),  # GQA 4:1
    (1, 4, 1, 96, 160, 32),  # MQA, ragged kv, non-multiple block
    (2, 16, 8, 32, 32, 128),  # gemma2-like ratios
    (1, 2, 2, 257, 130, 64),  # non-aligned lengths (padding paths)
]


def _qkv(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    ]


def _check(arrays, dtype, block=32, **kw):
    """The port against the JAX kernel (interpret mode) and its oracle."""
    jdt, tdt, tol = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = tfa.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    kernel = j_flash(jq, jk, jv, block_q=block, block_k=block, interpret=True, **kw)
    oracle = j_ref(jq, jk, jv, **kw)
    np.testing.assert_allclose(got, np.asarray(kernel, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_causal_matches_jax(shape, dtype):
    _check(_qkv(*shape, seed=shape[3] + shape[4]), dtype, causal=True)


@pytest.mark.parametrize("window", [1, 8, 64, 1024])
def test_sliding_window_matches_jax(window):
    _check(_qkv(1, 4, 2, 128, 128, 32, seed=window), "float32", causal=True, window=window)


@pytest.mark.parametrize("softcap", [1.0, 30.0, 50.0])
def test_softcap_matches_jax(softcap):
    _check(_qkv(1, 4, 4, 64, 64, 32, seed=int(softcap)), "float32", causal=True, softcap=softcap)


def test_non_causal_matches_jax():
    _check(_qkv(2, 4, 4, 64, 96, 32, seed=9), "float32", causal=False)


def test_custom_scale_matches_jax():
    _check(_qkv(1, 2, 2, 64, 64, 32, seed=13), "float32", causal=True, scale=0.5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_dim_256_mqa_matches_jax(dtype):
    """gemma-2b's head: D = 256, 8 query heads on one KV head."""
    _check(_qkv(1, 8, 1, 128, 128, 256, seed=256), dtype, causal=True)


def test_fully_masked_rows_are_zero():
    """Sq > Sk with a window: rows past Sk + window - 1 see no key and give 0."""
    arrays = _qkv(1, 4, 2, 96, 32, 32, seed=7)
    got = _check(arrays, "float32", causal=True, window=8)
    assert np.all(got[:, :, 39:] == 0.0)
    assert np.all(np.abs(got[:, :, :39]).sum(axis=-1) > 0)


def test_ops_attention_dispatches_on_use_kernel(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 32, 32, 16, seed=3))
    calls = []

    def fake(name):
        def fn(*args, **kw):
            calls.append(name)
            return tfa.flash_attention_ref(*args, **kw)

        return fn

    monkeypatch.setattr(tops, "flash_attention", fake("kernel"))
    monkeypatch.setattr(tops, "flash_attention_ref", fake("plain"))
    a = tops.attention(q, k, v, causal=True, window=4, use_kernel=True)
    b = tops.attention(q, k, v, causal=True, window=4)
    assert calls == ["kernel", "plain"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_call_is_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 1, 48, 48, 16, seed=5))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=True, softcap=30.0)
    want = tfa.flash_attention_ref(q, k, v, causal=True, softcap=30.0)
    assert torch.equal(got, want)
    assert tfa.launches == before


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper's CUDA path."""

    @property
    def device(self):
        return torch.device("cuda")


def test_cuda_tensor_launches_or_raises_never_falls_back(monkeypatch):
    from repro_torch.kernels import _build

    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tfa, "flash_attention_ref", no_fallback)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_loaded", {})
    q, k, v = (torch.from_numpy(a).as_subclass(_OnCuda) for a in _qkv(1, 2, 1, 8, 8, 16, seed=1))
    before = tfa.launches
    with pytest.raises(RuntimeError):
        tfa.flash_attention(q, k, v)
    assert tfa.launches == before


@pytest.mark.parametrize(
    "shapes,dtypes,err",
    [
        (((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), None, ValueError),  # 4 % 3 heads
        (((1, 4, 8, 16), (1, 2, 8, 32), (1, 2, 8, 32)), None, ValueError),  # head dims differ
        (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), torch.float16, TypeError),
    ],
)
def test_bad_inputs_raise(shapes, dtypes, err):
    q, k, v = (torch.zeros(s, dtype=dtypes or torch.float32) for s in shapes)
    with pytest.raises(err):
        tfa.flash_attention(q, k, v)
