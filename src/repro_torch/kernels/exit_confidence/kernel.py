"""ctypes bindings of the CUDA exit-confidence kernels
(csrc/exit_confidence.cu): the plain head and the fused norm + head.

Both take a leading group axis: ``h (G, B, D)`` with ``w (G, D, V)`` runs G
independent heads in one launch. The library is built on first call.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import check, count_launch, load, register_kernel

NAME = "exit_confidence"
NAME_FUSED = "exit_confidence_fused"
SOURCE = Path(__file__).parent / "csrc" / "exit_confidence.cu"
ROWS_PER_BLOCK = 8       # kRows in the source
THREADS = 256            # kThreads in the source
MAX_SMEM = 227 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NORM_CODES = {"rmsnorm": 1, "layernorm": 2}

register_kernel(NAME)
register_kernel(NAME_FUSED)

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _lib():
    lib = load(SOURCE)
    if lib.exit_confidence_launch.argtypes is None:
        lib.exit_confidence_launch.argtypes = (
            [_P, _I64, _I64, _P] + [_P] * 5 + [_I] * 7 + [_P])
        lib.exit_confidence_fused_launch.argtypes = (
            [_P, _I64, _I64, _P, _P, _P, _P] + [_P] * 5 + [_I] * 9 + [_P])
        lib.exit_confidence_launch.restype = _I
        lib.exit_confidence_fused_launch.restype = _I
    return lib


def _grouped(h, w):
    """(B, D), (D, V) -> (1, B, D), (1, D, V); (G, B, D), (G, D, V) as is."""
    if h.ndim != w.ndim or h.ndim not in (2, 3):
        raise ValueError(f"h {tuple(h.shape)} / w {tuple(w.shape)}: need "
                         f"(B, D) with (D, V) or (G, B, D) with (G, D, V)")
    if h.ndim == 2:
        h, w = h.unsqueeze(0), w.unsqueeze(0)
    g, _, d = h.shape
    if w.shape[0] != g or w.shape[1] != d:
        raise ValueError(f"h {tuple(h.shape)} and w {tuple(w.shape)} disagree")
    if not (h.is_cuda and w.device == h.device):
        raise ValueError("exit confidence kernels need h and w on one CUDA "
                         "device")
    if h.dtype not in _DTYPE_CODES or w.dtype != h.dtype:
        raise ValueError(f"h/w dtypes {h.dtype}/{w.dtype}: need one of "
                         f"{list(_DTYPE_CODES)} for both")
    if h.stride(2) != 1:
        raise ValueError("h rows must have a contiguous feature axis")
    if d * ROWS_PER_BLOCK * 4 > MAX_SMEM:
        raise ValueError(f"D={d} exceeds the kernel's shared-memory tile")
    return h, w.contiguous()


def _plan(g: int, b: int, v: int, device):
    """Split the vocabulary over blocks until the grid covers the SMs
    (twice over); (1, V) when the row tiles alone already do, or V is
    one column tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_tiles = -(-b // ROWS_PER_BLOCK)
    col_tiles = -(-v // THREADS)
    splits = max(1, min(col_tiles, (2 * sms) // (row_tiles * g)))
    cols = -(-col_tiles // splits) * THREADS
    return -(-v // cols), cols


def _outputs(g, b, v, device):
    splits, cols = _plan(g, b, v, device)
    conf = torch.empty((g, b), dtype=torch.float32, device=device)
    pred = torch.empty((g, b), dtype=torch.int32, device=device)
    parts = (None, None, None)
    if splits > 1:
        parts = (torch.empty((g, splits, b), dtype=torch.float32, device=device),
                 torch.empty((g, splits, b), dtype=torch.float32, device=device),
                 torch.empty((g, splits, b), dtype=torch.int32, device=device))
    return conf, pred, parts, splits, cols


def _ptr(t):
    return None if t is None else t.data_ptr()


def exit_confidence_cuda(h, w):
    """conf (…, B) f32 and pred (…, B) i32 of ``h @ w``, one launch."""
    squeeze = h.ndim == 2
    h3, w3 = _grouped(h, w)
    g, b, d = h3.shape
    v = w3.shape[2]
    conf, pred, parts, splits, cols = _outputs(g, b, v, h3.device)
    status = _lib().exit_confidence_launch(
        h3.data_ptr(), h3.stride(0), h3.stride(1), w3.data_ptr(),
        conf.data_ptr(), pred.data_ptr(), *map(_ptr, parts),
        g, b, d, v, splits, cols, _DTYPE_CODES[h3.dtype],
        torch.cuda.current_stream(h3.device).cuda_stream)
    check(status, NAME)
    count_launch(NAME)
    return (conf[0], pred[0]) if squeeze else (conf, pred)


def _norm_rows(t, grouped, g, b, d, dtype):
    """(D,) | (B, D) for (B, D) rows, (G, D) | (G, B, D) for grouped rows
    -> contiguous (G, 1 | B, D) in the activation dtype."""
    if not grouped:
        t = t.reshape(1, 1, d) if t.ndim == 1 else t.unsqueeze(0)
    elif t.ndim == 2:
        t = t.unsqueeze(1)
    if t.ndim != 3 or t.shape[0] != g or t.shape[1] not in (1, b) \
            or t.shape[2] != d:
        raise ValueError(f"norm parameter {tuple(t.shape)} does not fit "
                         f"G={g}, B={b}, D={d}")
    return t.to(dtype).contiguous()


def exit_confidence_fused_cuda(x, gamma, nbias, w, hbias, *, kind: str):
    """Fused exit epilogue on RAW pooled rows ``x``: norm (``kind``,
    ``gamma``/``nbias`` shared or per row; ``nbias`` None = 0), cast to
    the activation dtype, ``@ w`` (+ ``hbias`` (…, V) or None), online
    softmax. One launch."""
    squeeze = x.ndim == 2
    x3, w3 = _grouped(x, w)
    g, b, d = x3.shape
    v = w3.shape[2]
    gm = _norm_rows(gamma, not squeeze, g, b, d, x3.dtype)
    nb = None if nbias is None else _norm_rows(nbias, not squeeze, g, b, d,
                                               x3.dtype)
    if nb is not None and nb.shape != gm.shape:
        raise ValueError(f"norm scale {tuple(gm.shape)} and bias "
                         f"{tuple(nb.shape)} differ")
    hb = None if hbias is None else (
        hbias.reshape(g, v).to(torch.float32).contiguous())
    conf, pred, parts, splits, cols = _outputs(g, b, v, x3.device)
    status = _lib().exit_confidence_fused_launch(
        x3.data_ptr(), x3.stride(0), x3.stride(1), gm.data_ptr(), _ptr(nb),
        w3.data_ptr(), _ptr(hb), conf.data_ptr(), pred.data_ptr(),
        *map(_ptr, parts), g, b, d, v, gm.shape[1], _NORM_CODES[kind],
        splits, cols, _DTYPE_CODES[x3.dtype],
        torch.cuda.current_stream(x3.device).cuda_stream)
    check(status, NAME_FUSED)
    count_launch(NAME_FUSED)
    return (conf[0], pred[0]) if squeeze else (conf, pred)
