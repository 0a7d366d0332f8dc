"""ctypes binding of the CUDA block-attention kernel (csrc/flash_attention.cu).

The library is built on first call (`kernels._build`); nothing is built
or loaded at import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import check, count_launch, load, register_kernel

NAME = "flash_attention"
SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

register_kernel(NAME)


def _launcher():
    fn = load(SOURCE).flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) CUDA tensors of one dtype
    (float32 or bfloat16), head_dim contiguous, any other strides.
    Returns (B, Hq, Sq, d) whose memory is laid out (B, Sq, Hq, d), so the
    caller's merge of heads back into the model width is a view."""
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
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    status = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, hq, hkv, sq, skv, d, int(bool(causal)), int(window), float(scale),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check(status, NAME)
    count_launch(NAME)
    return out
