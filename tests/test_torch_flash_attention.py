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


# ---------------------------------------------------------------------------
# The tensor-core body's numerics, emulated on the CPU
# ---------------------------------------------------------------------------
TC_KEYS = 64  # keys per K/V tile of the tensor-core body


def _tc_emulation(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """The bf16 body's arithmetic in float32 on the CPU, tile for tile.

    q·kᵀ from the bf16 inputs as they are (each product is exact in float32)
    summed in float32, times ``scale`` after the product; the online softmax
    over 64-key tiles as the kernel runs it; ``p`` rounded to bf16 for p·v
    only (``l`` sums the float32 ``p``); the output rounded to bf16. Only the
    order of the float32 sums inside each product differs from the card.
    """
    neg_inf = -1e30
    _, hq, sq, d = q.shape
    sk = k.shape[2]
    group = hq // k.shape[1]
    scale = d**-0.5 if scale is None else scale
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    m = torch.full(qf.shape[:3], neg_inf)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape)
    q_pos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, TC_KEYS):
        ks = slice(k0, min(k0 + TC_KEYS, sk))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, ks]) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(ks.start, ks.stop)[None, :]
        vis = torch.ones((sq, ks.stop - ks.start), dtype=torch.bool)
        if causal:
            vis &= q_pos >= k_pos
        if window is not None:
            vis &= q_pos - k_pos < window
        s = torch.where(vis, s, torch.tensor(neg_inf))
        m_new = torch.maximum(m, s.amax(-1))
        dead = m_new <= neg_inf / 2
        alpha = torch.where(dead, torch.tensor(1.0), torch.exp(m - m_new))
        m_sub = torch.where(dead, torch.tensor(0.0), m_new)
        p = torch.where(vis, torch.exp(s - m_sub[..., None]), torch.tensor(0.0))
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf[:, :, ks]
        )
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)


TC_CASES = [(s, {}) for s in SHAPES] + [
    ((1, 8, 1, 128, 128, 256), {}),  # gemma-2b's head: D 256, 8 query heads on one KV head
    ((1, 4, 2, 200, 200, 64), {"window": 48, "softcap": 30.0}),
]


@pytest.mark.parametrize(
    "shape,kw", TC_CASES, ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else str(c)
)
def test_tensor_core_numerics_fit_the_bf16_bound(shape, kw):
    """bf16 q·k on the tensor cores and p rounded to bf16 for p·v stay inside
    3e-2 of the plain version and of the JAX kernel (interpret mode)."""
    kw = {"causal": True, **kw}
    arrays = _qkv(*shape, seed=shape[3] * 3 + shape[5])
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = _tc_emulation(tq, tk, tv, **kw).float().numpy()
    plain = tfa.flash_attention_ref(tq, tk, tv, **kw).float().numpy()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    kernel = np.asarray(j_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw), np.float32)
    np.testing.assert_allclose(got, plain, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, kernel, rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# The wrapper's dispatch, with the library replaced by a fake
# ---------------------------------------------------------------------------
class _FakeEntry:
    """Stands in for a ctypes function of the built library."""

    def __init__(self, name, calls, err=0):
        self.name, self.calls, self.err = name, calls, err
        self.argtypes = None
        self.restype = None

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return self.err


def _fake_library(monkeypatch, err=0):
    from repro_torch.kernels import _build

    calls = []
    lib = type("FakeLib", (), {})()
    for name in tfa._ENTRIES.values():
        setattr(lib, name, _FakeEntry(name, calls, err))
    monkeypatch.setattr(_build, "load", lambda source: lib)
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)

    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tfa, "flash_attention_ref", no_fallback)
    return calls


@pytest.mark.parametrize(
    "dtype,entry",
    [(torch.bfloat16, "flash_attention_bf16_launch"), (torch.float32, "flash_attention_f32_launch")],
    ids=["bfloat16-tensor_cores", "float32-cuda_cores"],
)
def test_dtype_reaches_its_entry(dtype, entry, monkeypatch):
    calls = _fake_library(monkeypatch)
    q, k, v = (
        torch.from_numpy(a).to(dtype).as_subclass(_OnCuda) for a in _qkv(1, 4, 2, 16, 16, 32, seed=2)
    )
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, causal=True, window=8, softcap=30.0)
    assert [name for name, _ in calls] == [entry]
    args = calls[0][1]
    assert len(args) == len(tfa._ARGTYPES)
    assert args[:6] == (1, 4, 2, 16, 16, 32)
    assert tfa.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype


def _c_params(text, macro):
    body = text.split(f"#define {macro}", 1)[1].split("\n\n", 1)[0]
    return [p.strip() for p in body.replace("\\", " ").split(",")]


def test_argtypes_match_the_c_signature():
    import ctypes
    from pathlib import Path

    text = (Path(tfa.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    params = _c_params(text, "FLASH_PARAMS")
    for entry in tfa._ENTRIES.values():
        assert f'extern "C" int {entry}(FLASH_PARAMS)' in text
    assert len(params) == len(tfa._ARGTYPES) == 26
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    for param, argtype in zip(params, tfa._ARGTYPES):
        c_type = param.rsplit(" ", 1)[0].strip()
        want = ctypes.c_void_p if "*" in param else kinds[c_type]
        assert argtype is want, param


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_launch_error_raises_never_falls_back(dtype, monkeypatch):
    calls = _fake_library(monkeypatch, err=700)  # cudaErrorIllegalAddress
    q, k, v = (torch.from_numpy(a).to(dtype).as_subclass(_OnCuda) for a in _qkv(1, 2, 1, 8, 8, 16, seed=4))
    before = tfa.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tfa.flash_attention(q, k, v)
    assert len(calls) == 1 and tfa.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_failed_build_raises_never_falls_back(dtype, monkeypatch):
    from repro_torch.kernels import _build

    _fake_library(monkeypatch)

    def failed_build(source):
        raise RuntimeError(f"nvcc failed to build {source}.cu (exit 1)")

    monkeypatch.setattr(_build, "load", failed_build)
    q, k, v = (torch.from_numpy(a).to(dtype).as_subclass(_OnCuda) for a in _qkv(1, 2, 1, 8, 8, 16, seed=6))
    before = tfa.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfa.flash_attention(q, k, v)
    assert tfa.launches == before


def test_tma_rows_pass_aligned_inputs_and_pad_the_rest():
    """The bf16 body's TMA loads take (batch, head, seq) strides as they are
    when rows start 16-byte aligned; other inputs are copied into rows padded
    with zeros to a multiple of 8 columns."""
    bshd = torch.randn(2, 30, 8, 256).to(torch.bfloat16).transpose(1, 2)  # as attn_apply passes
    assert tfa._tma_rows(bshd) is bshd
    odd = torch.randn(1, 2, 5, 20).to(torch.bfloat16)  # D = 20: 40-byte rows
    padded = tfa._tma_rows(odd)
    assert padded.shape == (1, 2, 5, 24) and padded.is_contiguous()
    assert torch.equal(padded[..., :20], odd) and not padded[..., 20:].any()
    expanded = torch.randn(1, 1, 7, 32).to(torch.bfloat16).expand(3, 2, 7, 32)  # stride 0
    copied = tfa._tma_rows(expanded)
    assert copied is not expanded and torch.equal(copied, expanded)
    assert all(copied.stride(i) > 0 and copied.stride(i) % 8 == 0 for i in range(3))
