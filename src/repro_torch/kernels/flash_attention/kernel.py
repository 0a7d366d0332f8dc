"""ctypes binding of the CUDA block-attention kernel (csrc/flash_attention.cu).

Each call runs one of two variants, chosen by `attention_variant` from the
dtype, the head dim and the 16-byte alignment of the rows alone. The
library is built on first call (`kernels._build`); nothing is built or
loaded at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (check, count_launch, load,
                                        refuse_grad, register_kernel,
                                        rows_aligned)

NAME = "flash_attention"
SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128
VARIANTS = ("tensor_core", "cuda_core")
TENSOR_CORE_HEAD_DIMS = (64, 128)
_VARIANT_CODES = {"cuda_core": 0, "tensor_core": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

register_kernel(NAME, VARIANTS)


def attention_variant(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """tensor_core for bf16 at head dim 64 or 128 with 16-byte aligned
    q/k/v rows, else cuda_core. A pure function: it never depends on a
    build or a launch."""
    if dtype == torch.bfloat16 and d in TENSOR_CORE_HEAD_DIMS and aligned:
        return "tensor_core"
    return "cuda_core"


def _launcher():
    fn = load(SOURCE).flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) CUDA tensors of one dtype
    (float32 or bfloat16), head_dim contiguous, any other strides.
    Returns (B, Hq, Sq, d) whose memory is laid out (B, Sq, Hq, d), so the
    caller's merge of heads back into the model width is a view.

    The forward alone: under grad it raises (`_build.refuse_grad`); a
    gradient goes through `ops.FlashAttention`, which calls this with
    grad mode off and saves what `ops.attention_backward` reads."""
    refuse_grad(NAME, q, k, v)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                         f"one of {list(_DTYPE_CODES)} for all three")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, H, S, d), k == v")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} / kv "
                         f"{tuple(k.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} is not supported")
    if min(q.stride(3), k.stride(3), v.stride(3)) != 1:
        raise ValueError("head_dim must be the contiguous axis of q, k, v")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    variant = attention_variant(q.dtype, d, rows_aligned(q, k, v, out))
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    status = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, hq, hkv, sq, skv, d, int(bool(causal)), int(window), float(scale),
        _DTYPE_CODES[q.dtype], _VARIANT_CODES[variant],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(status, f"{NAME}/{variant}")
    count_launch(NAME, variant)
    return out
