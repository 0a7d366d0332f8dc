"""ctypes binding of the CUDA WKV6 recurrence kernel and of its backward
(csrc/wkv6.cu).

Each call runs one of two variants, chosen by `wkv6_variant` from the
layout of r, k, v and w alone: ``vec16`` stages whole rows with 16-byte
``cp.async`` copies, ``scalar`` element by element. The backward
(`wkv6_backward_cuda`, a kernel of its own) has the same two variants,
chosen by `wkv6_backward_variant`. The library is built on first call (`kernels._build`); nothing is built or loaded at
import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (check, count_launch, load,
                                        refuse_grad, register_kernel,
                                        rows_aligned)

NAME = "wkv6"
BACKWARD = "wkv6_backward"
SOURCE = Path(__file__).parent / "csrc" / "wkv6.cu"
MAX_DIM = 64                      # kMaxDim in the source: dk, dv <= 64
VARIANTS = ("vec16", "scalar")
_VARIANT_CODES = {"scalar": 0, "vec16": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# steps between the states the backward saves (kBwdChunk in the source)
BACKWARD_CHUNK = 4

register_kernel(NAME, VARIANTS)
register_kernel(BACKWARD, VARIANTS)


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


def wkv6_backward_variant(r, k, v, w, dy) -> str:
    """The backward's variant: ``vec16`` when r, k, v, w (`wkv6_variant`)
    and dy all have 16-byte rows, else ``scalar``. A pure function of the
    tensors' shapes and layout."""
    if wkv6_variant(r, k, v, w) == "vec16" and dy.stride(-1) == 1 \
            and dy.shape[-1] * dy.element_size() % 16 == 0 \
            and rows_aligned(dy):
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
        lib.wkv6_backward_launch.argtypes = ([ctypes.c_void_p] * 15
                                             + [ctypes.c_int] * 7
                                             + [ctypes.c_void_p])
        lib.wkv6_backward_launch.restype = ctypes.c_int
        lib.wkv6_backward_occupancy.argtypes = ([ctypes.c_int] * 2
                                                + [ctypes.c_void_p])
        lib.wkv6_backward_occupancy.restype = ctypes.c_int
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


def backward_occupancy(dtype: torch.dtype, variant: str) -> dict:
    """`occupancy` of the backward instantiation a call with r/k/v in
    ``dtype`` and ``variant`` launches (its shared memory is dynamic:
    ``shared_bytes`` is what a launch asks)."""
    out = (ctypes.c_int * 4)()
    check(_lib().wkv6_backward_occupancy(_DTYPE_CODES[dtype],
                                         _VARIANT_CODES[variant],
                                         ctypes.addressof(out)),
          f"{BACKWARD} occupancy")
    return dict(zip(("blocks_per_sm", "registers", "shared_bytes",
                     "local_bytes"), out))


def _check_inputs(name, r, k, v, w, u):
    """The device, dtype and shape checks the forward and the backward
    share. Returns (b, h, t, dk, dv)."""
    tensors = (r, k, v, w, u)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError(f"{name} needs r, k, v, w, u on one CUDA device")
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
    return b, h, t, dk, dv


def _strides(*tensors):
    strides = []
    for x in tensors:
        strides += list(x.stride())
    return (ctypes.c_int64 * len(strides))(*strides)


def wkv6_cuda(r, k, v, w, u):
    """r, k: (B, H, T, dk) and v: (B, H, T, dv), one dtype (float32 or
    bfloat16); w: (B, H, T, dk) and u: (H, dk) float32; all on one CUDA
    device, any strides. dk, dv <= 64.

    Returns (y (B, H, T, dv) f32 whose memory is laid out (B, T, H, dv),
    so the caller's merge of heads back into the model width is a view;
    final state (B, H, dk, dv) f32), from a zero state. One launch of the
    variant `wkv6_variant` picks. Raises when a gradient is wanted: the
    kernel has no backward (`_build.refuse_grad`)."""
    refuse_grad(NAME, r, k, v, w, u)
    b, h, t, dk, dv = _check_inputs("wkv6_cuda", r, k, v, w, u)
    y = torch.empty((b, t, h, dv), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    s = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    variant = wkv6_variant(r, k, v, w)
    stride_arr = _strides(r, k, v, w, y, u)
    status = _lib().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), s.data_ptr(), ctypes.addressof(stride_arr),
        b, h, t, dk, dv, _DTYPE_CODES[r.dtype], _VARIANT_CODES[variant],
        torch.cuda.current_stream(r.device).cuda_stream)
    check(status, f"{NAME}/{variant}")
    count_launch(NAME, variant)
    return y, s


def wkv6_backward_cuda(r, k, v, w, u, dy, ds_final=None):
    """The gradients of `wkv6_cuda` (dr, dk, dv, dw, du): r, k, v, w, u as
    `wkv6_cuda` takes them, dy (B, H, T, dv) float32 the cotangent of y
    and ``ds_final`` (B, H, dk, dv) float32 that of the final state (None:
    zeros); any strides.

    Returns dr, dk (B, H, T, dk) and dv (B, H, T, dv) in r's dtype, dw
    (B, H, T, dk) float32, laid out (B, T, H, ·) as y is, and du (H, dk)
    float32 (the per-(batch, head) partials summed over the batch in
    order: no atomics, so equal inputs give bitwise equal gradients). One
    backward launch of the variant `wkv6_backward_variant` picks (and the
    batch sum). Raises when a
    gradient of the gradients is wanted."""
    refuse_grad(BACKWARD, r, k, v, w, u, dy, ds_final)
    b, h, t, dk, dv = _check_inputs("wkv6_backward_cuda", r, k, v, w, u)
    if not (dy.is_cuda and dy.device == r.device and dy.dtype == torch.float32
            and dy.shape == v.shape):
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} on {dy.device}: "
                         f"need float32 {tuple(v.shape)} on {r.device}")
    if ds_final is not None and not (
            ds_final.is_cuda and ds_final.device == r.device
            and ds_final.dtype == torch.float32
            and ds_final.shape == (b, h, dk, dv)):
        raise ValueError(f"ds_final {ds_final.dtype} "
                         f"{tuple(ds_final.shape)}: need float32 "
                         f"{(b, h, dk, dv)} on {r.device}")
    dev = r.device

    def grad(dtype, d):
        return torch.empty((b, t, h, d), dtype=dtype, device=dev).transpose(1, 2)
    dr, dk_, dv_ = grad(r.dtype, dk), grad(r.dtype, dk), grad(r.dtype, dv)
    dw = grad(torch.float32, dk)
    du = torch.empty((h, dk), dtype=torch.float32, device=dev)
    variant = wkv6_backward_variant(r, k, v, w, dy)
    nc = -(-t // BACKWARD_CHUNK)
    # the states at the chunk starts (16 KB each: 64 x 64 f32), and du's
    # per-(batch, head) partials
    ckpt = torch.empty((b * h * nc * MAX_DIM * MAX_DIM,), dtype=torch.float32,
                       device=dev)
    du_part = torch.empty((b * h * dk,), dtype=torch.float32, device=dev)
    # (without ds_final the kernel reads no ds strides: dy's fill the slot)
    stride_arr = _strides(r, k, v, w, dy, dr, dk_, dv_, dw, u,
                          dy if ds_final is None else ds_final)
    status = _lib().wkv6_backward_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        dy.data_ptr(), None if ds_final is None else ds_final.data_ptr(),
        dr.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dw.data_ptr(),
        du.data_ptr(), ckpt.data_ptr(), du_part.data_ptr(),
        ctypes.addressof(stride_arr), b, h, t, dk, dv, _DTYPE_CODES[r.dtype],
        _VARIANT_CODES[variant],
        torch.cuda.current_stream(dev).cuda_stream)
    check(status, f"{BACKWARD}/{variant}")
    count_launch(BACKWARD, variant)
    return dr, dk_, dv_, dw, du
