"""ctypes binding of the CUDA WKV6 recurrence kernel (csrc/wkv6.cu).

Each call runs one of two variants, chosen by `wkv6_variant` from the
layout of r, k, v and w alone: ``vec16`` stages whole rows with 16-byte
``cp.async`` copies, ``scalar`` element by element. The library is built
on first call (`kernels._build`); nothing is built or loaded at import
time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (check, count_launch, load,
                                        refuse_grad, register_kernel,
                                        rows_aligned)

NAME = "wkv6"
SOURCE = Path(__file__).parent / "csrc" / "wkv6.cu"
MAX_DIM = 64                      # kMaxDim in the source: dk, dv <= 64
VARIANTS = ("vec16", "scalar")
_VARIANT_CODES = {"scalar": 0, "vec16": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

register_kernel(NAME, VARIANTS)


def wkv6_variant(r, k, v, w) -> str:
    """vec16 when every row of r, k, v and w can be copied in 16-byte
    pieces: unit feature stride, rows starting on 16 bytes
    (`rows_aligned`) and a multiple of 16 bytes long; else scalar. A pure
    function of the tensors' layout: it never depends on a build or a
    launch."""
    xs = (r, k, v, w)
    if all(x.stride(-1) == 1 and x.shape[-1] * x.element_size() % 16 == 0
           for x in xs) and rows_aligned(*xs):
        return "vec16"
    return "scalar"


def _lib():
    lib = load(SOURCE)
    if lib.wkv6_launch.argtypes is None:
        lib.wkv6_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                    + [ctypes.c_void_p])
        lib.wkv6_launch.restype = ctypes.c_int
        lib.wkv6_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.wkv6_occupancy.restype = ctypes.c_int
    return lib


def occupancy(dtype: torch.dtype, dk: int, variant: str) -> dict:
    """What the CUDA runtime reports for the instantiation a call with
    r/k/v in ``dtype``, this dk and ``variant`` launches: resident blocks
    per SM at its 128 threads, registers per thread, static shared memory
    per block and local (spill) bytes per thread."""
    out = (ctypes.c_int * 4)()
    check(_lib().wkv6_occupancy(_DTYPE_CODES[dtype], dk, _VARIANT_CODES[variant],
                                ctypes.addressof(out)), f"{NAME} occupancy")
    return dict(zip(("blocks_per_sm", "registers", "shared_bytes",
                     "local_bytes"), out))


def wkv6_cuda(r, k, v, w, u):
    """r, k: (B, H, T, dk) and v: (B, H, T, dv), one dtype (float32 or
    bfloat16); w: (B, H, T, dk) and u: (H, dk) float32; all on one CUDA
    device, any strides. dk, dv <= 64.

    Returns (y (B, H, T, dv) f32 whose memory is laid out (B, T, H, dv),
    so the caller's merge of heads back into the model width is a view;
    final state (B, H, dk, dv) f32), from a zero state. One launch of the
    variant `wkv6_variant` picks. Raises when a gradient is wanted: the
    kernel has no backward (`_build.refuse_grad`)."""
    tensors = (r, k, v, w, u)
    refuse_grad(NAME, *tensors)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("wkv6_cuda needs r, k, v, w, u on one CUDA device")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype}: need "
                         f"one of {list(_DTYPE_CODES)} for all three")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"w {w.dtype} / u {u.dtype}: need float32 for both")
    if r.ndim != 4 or k.shape != r.shape or w.shape != r.shape or v.ndim != 4 \
            or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}: need "
                         f"(B, H, T, dk) for r, k, w and (B, H, T, dv) for v")
    b, h, t, dk = r.shape
    dv = v.shape[3]
    if u.shape != (h, dk):
        raise ValueError(f"u {tuple(u.shape)}: need (H, dk) = ({h}, {dk})")
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM and t >= 1 and b * h >= 1):
        raise ValueError(f"dk={dk}, dv={dv}, T={t}, B*H={b * h}: need "
                         f"1 <= dk, dv <= {MAX_DIM}, T >= 1, B*H >= 1")
    y = torch.empty((b, t, h, dv), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    s = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    variant = wkv6_variant(r, k, v, w)
    strides = []
    for x in (r, k, v, w, y):
        strides += list(x.stride())
    strides += list(u.stride())
    stride_arr = (ctypes.c_int64 * len(strides))(*strides)
    status = _lib().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), s.data_ptr(), ctypes.addressof(stride_arr),
        b, h, t, dk, dv, _DTYPE_CODES[r.dtype], _VARIANT_CODES[variant],
        torch.cuda.current_stream(r.device).cuda_stream)
    check(status, f"{NAME}/{variant}")
    count_launch(NAME, variant)
    return y, s
