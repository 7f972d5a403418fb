"""Flash attention (online softmax): CUDA kernel wrapper and its plain PyTorch version.

Port of the JAX package's Pallas ``repro.kernels.flash_attention`` (kernel
B3) and of its oracle ``repro.kernels.ref.attention_ref``. For
``q (B, Hq, Sq, D)`` and ``k, v (B, Hkv, Sk, D)``, with ``Hq`` a multiple of
``Hkv`` (query head ``h`` reads KV head ``h // (Hq // Hkv)``; K and V are
never repeated in memory):

* scores ``s = (q·scale) kᵀ`` in float32 (``scale`` defaults to ``D**-0.5``),
  then ``softcap·tanh(s/softcap)`` when a softcap is given;
* a key is visible to a query when ``q_pos >= k_pos`` (if ``causal``) and
  ``q_pos - k_pos < window`` (if a window is given); positions count from
  0 for both, and ``Sq`` may differ from ``Sk``;
* the softmax over the visible keys, times ``v``, in float32, cast to
  ``q``'s dtype. A row that sees no key gives 0.

On a CPU tensor :func:`flash_attention` runs the plain version
(:func:`flash_attention_ref`, a materialized softmax); on a CUDA tensor it
launches the hand-written kernel of ``csrc/flash_attention.cu`` or raises.
The kernel has two bodies, chosen by dtype: bfloat16 inputs go to the
tensor cores (``q·kᵀ`` from the bf16 inputs with float32 accumulation, then
times ``scale``; ``p`` rounded to bf16 for ``p·v``), float32 inputs to the
CUDA cores in float32 throughout. The kernel and the plain version sum in
other orders, so they agree within a tolerance, not bit for bit; the kernel
uses no atomics, so a repeated launch gives the same bits.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["flash_attention", "flash_attention_ref", "launches", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256  # the widest head of any config (gemma, recurrentgemma)

# Kernel launches of flash_attention on CUDA tensors (one per call that
# reaches the card). Callers reset it to 0 and read it around a run.
launches = 0

# The C entry of each dtype: bfloat16 runs the tensor-core body, float32 the
# CUDA-core body. Both take _ARGTYPES.
_ENTRIES = {torch.float32: "flash_attention_f32_launch", torch.bfloat16: "flash_attention_bf16_launch"}


def _validate(q, k, v):
    if q.dtype not in _ENTRIES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"want q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({k.shape[1]})")


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------
def flash_attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Naive float32 softmax attention with the same masking semantics."""
    _validate(q, k, v)
    _, hq, sq, d = q.shape
    sk = k.shape[2]
    group = hq // k.shape[1]
    if scale is None:
        scale = d**-0.5
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------
_ARGTYPES = (
    [ctypes.c_int] * 6  # B, Hq, Hkv, Sq, Sk, D
    + [ctypes.c_longlong] * 9  # (batch, head, seq) strides of q, k, v
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    # scale, causal, has_window, window, has_softcap, softcap
    + [ctypes.c_void_p] * 4  # q, k, v, out
    + [ctypes.c_void_p]  # stream
)


def _library(dtype):
    from repro_torch.kernels import _build

    fn = getattr(_build.load("flash_attention"), _ENTRIES[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _tma_rows(t):
    """``t`` with rows the tensor-core body's TMA loads can take.

    TMA needs a 16-byte aligned base and (batch, head, seq) strides that are
    positive multiples of 16 bytes (8 bf16 elements; extents of 1 do not
    count), so D a multiple of 8 too. Other inputs are copied into zero-padded rows of
    ``ceil(D / 8) · 8`` columns; the zeros add nothing to either product.
    """
    d = t.shape[3]
    if d % 8 == 0 and t.data_ptr() % 16 == 0 and all(
        t.stride(i) > 0 and t.stride(i) % 8 == 0 for i in range(3) if t.shape[i] > 1
    ):
        return t
    rows = t.new_zeros((*t.shape[:3], -(-d // 8) * 8))
    rows[..., :d] = t
    return rows


def _launch(q, k, v, causal, window, softcap, scale):
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along the head dimension")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} is not supported by the kernel")
    if max(b * hq, sq, sk) >= 2**31:
        raise ValueError("flash_attention indexes rows with int32: B·Hq, Sq and Sk must be < 2**31")
    launch = _library(q.dtype)  # builds csrc/flash_attention.cu at first use
    out = q.new_empty((b, hq, sq, d))
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        q, k, v = _tma_rows(q), _tma_rows(k), _tma_rows(v)
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    err = launch(
        b, hq, hkv, sq, sk, d, *strides,
        float(scale), int(causal), int(window is not None),
        0 if window is None else int(window),
        int(softcap is not None), 0.0 if softcap is None else float(softcap),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Tiled online-softmax attention. Returns ``(B, Hq, Sq, D)`` in q's dtype.

    Any strides are taken as long as the head dimension is contiguous, so
    a ``(B, S, H, D)`` tensor transposed to ``(B, H, S, D)`` needs no copy.
    """
    _validate(q, k, v)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    return _launch(q, k, v, causal, window, softcap, scale)
