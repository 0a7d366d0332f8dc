"""ctypes bindings of the CUDA exit-confidence kernels
(csrc/exit_confidence.cu): the plain head and the fused norm + head.

Both take a leading group axis: ``h (G, B, D)`` with ``w (G, D, V)`` runs G
independent heads in one launch, and a head bias ``(G, V)`` natively. Each
call runs one of three kernel variants, chosen by `exit_variant` from the
dtype, D, V and the 16-byte alignment of the rows alone; the vocabulary is
split over blocks by `plan`. The library is built on first call.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import (check, count_launch, load,
                                        refuse_grad, register_kernel,
                                        rows_aligned)

NAME = "exit_confidence"
NAME_FUSED = "exit_confidence_fused"
SOURCE = Path(__file__).parent / "csrc" / "exit_confidence.cu"
VARIANTS = ("tensor_core", "small_head", "cuda_core")
_VARIANT_CODES = {"cuda_core": 0, "small_head": 1, "tensor_core": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NORM_CODES = {"rmsnorm": 1, "layernorm": 2}
MAX_SMEM = 227 * 1024

# the source's constants, by variant
SMALL_VOCAB = 64          # kSmallVocab: small_head takes V up to this
CUDA_CORE_ROWS = 8        # kRows
CUDA_CORE_COLS = 256      # kThreads: one column per thread
TC_COLS = 128             # both tensor-core tiles' columns (kWgBN)
TC_SMALL_ROWS = 32        # kTcSmallRows: M up to this, the 32-row mma.sync tile
TC_ROWS = 128             # kWgBM: the wgmma tile of M > 32
# the tensor_core variant's two tiles: mma.sync for M <= TC_SMALL_ROWS
# rows (per group), wgmma above
TC_TILES = ("mma_sync", "wgmma")


class Plan(NamedTuple):
    """How a call is cut: ``splits`` vocabulary splits of
    ``cols_per_split`` columns (a multiple of the column tile), over row
    tiles of ``rows_per_tile``."""
    splits: int
    cols_per_split: int
    rows_per_tile: int


register_kernel(NAME, VARIANTS, {"tensor_core": TC_TILES})
register_kernel(NAME_FUSED, VARIANTS, {"tensor_core": TC_TILES})

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _lib():
    lib = load(SOURCE)
    if lib.exit_confidence_launch.argtypes is None:
        lib.exit_confidence_launch.argtypes = (
            [_P, _I64, _I64, _P, _P] + [_P] * 5 + [_I] * 8 + [_P])
        lib.exit_confidence_fused_launch.argtypes = (
            [_P, _I64, _I64, _P, _P, _P, _P] + [_P] * 6 + [_I] * 10 + [_P])
        lib.exit_confidence_launch.restype = _I
        lib.exit_confidence_fused_launch.restype = _I
    return lib


def exit_variant(dtype: torch.dtype, d: int, v: int, aligned: bool) -> str:
    """The kernel variant for h (…, D) @ w (D, V) in ``dtype``; ``aligned``:
    the rows of h (and of the norm parameters) and the start of w lie on
    16 bytes. A pure function: it never depends on a build or a launch."""
    vec = 16 // dtype.itemsize
    if aligned and v <= SMALL_VOCAB and d % vec == 0:
        return "small_head"
    # an even V keeps every row of a 16-byte-aligned bf16 w on 4 bytes: the
    # tensor-core kernel stages w in 16-byte pieces when V % 8 == 0, else
    # in 4-byte ones
    if dtype == torch.bfloat16 and aligned and d % 8 == 0 and v % 2 == 0:
        return "tensor_core"
    return "cuda_core"


def tc_tile(b: int) -> str:
    """The tensor_core variant's tile at B rows per group: the 32-row
    mma.sync tile up to TC_SMALL_ROWS, the 128-row wgmma tile above."""
    return "mma_sync" if b <= TC_SMALL_ROWS else "wgmma"


def tile_shape(variant: str, b: int) -> tuple:
    """(rows per tile, columns per tile, blocks that fit one SM) of a
    variant at B rows, as the source launches it."""
    if variant == "tensor_core":
        # 2 blocks an SM: splits of 2 column tiles at the LM head, so each
        # holds enough of the softmax mass that losing one shows
        rows = TC_SMALL_ROWS if tc_tile(b) == "mma_sync" else TC_ROWS
        return rows, TC_COLS, 2
    if variant == "small_head":
        return 4, SMALL_VOCAB, 0           # a warp per row; V is never split
    return CUDA_CORE_ROWS, CUDA_CORE_COLS, 2


def plan(g: int, b: int, v: int, sm_count: int, rows_per_tile: int,
         cols_per_tile: int, blocks_per_sm: int) -> Plan:
    """Split the vocabulary over blocks until the grid covers
    ``sm_count * blocks_per_sm`` block slots; (1, V) when the row tiles
    alone already do, or V is one column tile (or ``blocks_per_sm`` is 0).
    Every column falls in exactly one split; splits stay under the grid's
    65535 limit."""
    row_tiles = -(-b // rows_per_tile)
    col_tiles = -(-v // cols_per_tile)
    want = (sm_count * blocks_per_sm) // (row_tiles * g)
    splits = max(1, min(col_tiles, want, 65535))
    cols = -(-col_tiles // splits) * cols_per_tile
    return Plan(-(-v // cols), cols, rows_per_tile)


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
    return h, w.contiguous()


def _head_bias(hbias, g, v):
    return None if hbias is None else (
        hbias.reshape(g, v).to(torch.float32).contiguous())


def _launch_shape(h3, w3, variant):
    """The plan and the outputs (conf, pred, partial triples) of a call."""
    g, b, d = h3.shape
    v = w3.shape[2]
    if variant == "cuda_core" and d * CUDA_CORE_ROWS * 4 > MAX_SMEM:
        raise ValueError(f"D={d} exceeds the cuda_core variant's "
                         f"shared-memory tile")
    sms = torch.cuda.get_device_properties(h3.device).multi_processor_count
    pl = plan(g, b, v, sms, *tile_shape(variant, b))
    dev = h3.device
    conf = torch.empty((g, b), dtype=torch.float32, device=dev)
    pred = torch.empty((g, b), dtype=torch.int32, device=dev)
    parts = (None, None, None)
    if pl.splits > 1:
        parts = (torch.empty((g, pl.splits, b), dtype=torch.float32, device=dev),
                 torch.empty((g, pl.splits, b), dtype=torch.float32, device=dev),
                 torch.empty((g, pl.splits, b), dtype=torch.int32, device=dev))
    return pl, conf, pred, parts


def _tile(variant: str, b: int):
    return tc_tile(b) if variant == "tensor_core" else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def exit_confidence_cuda(h, w, hbias=None):
    """conf (…, B) f32 and pred (…, B) i32 of ``h @ w`` (+ ``hbias`` (…,
    V)), one call of one variant. Raises when a gradient is wanted: the
    kernel has no backward (`_build.refuse_grad`)."""
    refuse_grad(NAME, h, w, hbias)
    squeeze = h.ndim == 2
    h3, w3 = _grouped(h, w)
    g, b, d = h3.shape
    v = w3.shape[2]
    variant = exit_variant(h3.dtype, d, v,
                           rows_aligned(h3) and w3.data_ptr() % 16 == 0)
    hb = _head_bias(hbias, g, v)
    pl, conf, pred, parts = _launch_shape(h3, w3, variant)
    status = _lib().exit_confidence_launch(
        h3.data_ptr(), h3.stride(0), h3.stride(1), w3.data_ptr(), _ptr(hb),
        conf.data_ptr(), pred.data_ptr(), *map(_ptr, parts),
        g, b, d, v, pl.splits, pl.cols_per_split, _DTYPE_CODES[h3.dtype],
        _VARIANT_CODES[variant],
        torch.cuda.current_stream(h3.device).cuda_stream)
    check(status, f"{NAME}/{variant}")
    count_launch(NAME, variant, _tile(variant, b))
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
    softmax. One call of one variant. Raises when a gradient is wanted:
    the kernel has no backward (`_build.refuse_grad`)."""
    refuse_grad(NAME_FUSED, x, gamma, nbias, w, hbias)
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
    aligned = (rows_aligned(x3, *(t for t in (gm, nb) if t is not None))
               and w3.data_ptr() % 16 == 0)
    variant = exit_variant(x3.dtype, d, v, aligned)
    hb = _head_bias(hbias, g, v)
    pl, conf, pred, parts = _launch_shape(x3, w3, variant)
    # the tensor-core path normalises the rows into this scratch first
    normed = torch.empty((g, b, d), dtype=x3.dtype, device=x3.device) \
        if variant == "tensor_core" else None
    status = _lib().exit_confidence_fused_launch(
        x3.data_ptr(), x3.stride(0), x3.stride(1), gm.data_ptr(), _ptr(nb),
        w3.data_ptr(), _ptr(hb), conf.data_ptr(), pred.data_ptr(),
        *map(_ptr, parts), _ptr(normed), g, b, d, v, gm.shape[1],
        _NORM_CODES[kind],
        pl.splits, pl.cols_per_split, _DTYPE_CODES[x3.dtype],
        _VARIANT_CODES[variant],
        torch.cuda.current_stream(x3.device).cuda_stream)
    check(status, f"{NAME_FUSED}/{variant}")
    count_launch(NAME_FUSED, variant, _tile(variant, b))
    return (conf[0], pred[0]) if squeeze else (conf, pred)
