"""ctypes binding of the CUDA block-attention kernel (csrc/flash_attention.cu)
and of its backward (csrc/flash_attention_backward.cu).

Each call runs one of two variants, chosen by `attention_variant` from the
dtype, the head dim and the 16-byte alignment of the rows alone. The
backward (`flash_attention_backward_cuda`, a kernel of its own) has the
same two variants, chosen by `attention_backward_variant`, and its
tensor_core variant two tiles (mma.sync or wgmma), chosen by
`attention_backward_tile` from the shapes; the wgmma tile splits its dQ
pass over keys (`dq_key_splits`) where the grid underfills the card. The
libraries are built on first call (`kernels._build`); nothing is built or
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
BACKWARD = "flash_attention_backward"
SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
BACKWARD_SOURCE = Path(__file__).parent / "csrc" / "flash_attention_backward.cu"
MAX_HEAD_DIM = 128
VARIANTS = ("tensor_core", "cuda_core")
TENSOR_CORE_HEAD_DIMS = (64, 128)
_VARIANT_CODES = {"cuda_core": 0, "tensor_core": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's tensor_core tiles: mma.sync m16n8k16 on 4 warps, or wgmma
# on two warpgroups; the wgmma dQ pass has blocks of WG_ROWS query rows
# (kWgRows) walking KV tiles of WG_KV keys (kWgKv)
BACKWARD_TILES = ("mma_sync", "wgmma")
_TILE_CODES = {"mma_sync": 0, "wgmma": 1}
WG_ROWS = 128
WG_KV = 64
# the wgmma tile from this many keys on, at either head dim: in the A/B of
# the two tiles in turns on the H100 (tools/attention_ab.py --tiles;
# PERF.md §6) wgmma leads at every shape from 256 keys on (by
# 18-63 %); below, it leads by 4-24 % at most shapes but trails by 11 %
# at 128 causal keys at head dim 64, and the families' 32- and 64-token
# training shapes stay on mma_sync
WGMMA_MIN_KEYS = 256
# the dQ pass's key splits aim at this many blocks an SM
DQ_SPLIT_BLOCKS_PER_SM = 2
H100_SMS = 132

register_kernel(NAME, VARIANTS)
register_kernel(BACKWARD, VARIANTS, tiles={"tensor_core": BACKWARD_TILES})


def attention_variant(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """tensor_core for bf16 at head dim 64 or 128 with 16-byte aligned
    q/k/v rows, else cuda_core. A pure function: it never depends on a
    build or a launch."""
    if dtype == torch.bfloat16 and d in TENSOR_CORE_HEAD_DIMS and aligned:
        return "tensor_core"
    return "cuda_core"


def attention_backward_variant(dtype: torch.dtype, d: int,
                               aligned: bool) -> str:
    """The backward's variant, by the forward's rule: tensor_core for bf16
    at head dim 64 or 128 with every row of q, k, v, the output, dO and
    the three gradients 16-byte aligned, else cuda_core. A pure function:
    it never depends on a build or a launch."""
    return attention_variant(dtype, d, aligned)


def attention_backward_tile(dtype: torch.dtype, d: int, aligned: bool,
                            sq: int, skv: int) -> str | None:
    """The tensor_core variant's tile for q rows ``sq`` over ``skv`` keys:
    wgmma from WGMMA_MIN_KEYS keys on, else mma_sync; None for the
    cuda_core variant. A pure function of the shapes: it never depends on
    a build or a launch."""
    if attention_backward_variant(dtype, d, aligned) != "tensor_core":
        return None
    return "wgmma" if skv >= WGMMA_MIN_KEYS else "mma_sync"


def dq_key_splits(bh: int, sq: int, skv: int, sms: int = H100_SMS) -> int:
    """The wgmma tile's splits of its dQ pass over the KV tiles: 1 where
    its ``bh`` × ⌈sq / WG_ROWS⌉ blocks (bh = batch × query heads) already
    fill ``sms`` SMs, else enough for DQ_SPLIT_BLOCKS_PER_SM blocks an SM,
    at most one a KV tile."""
    blocks = bh * -(-sq // WG_ROWS)
    if blocks >= sms:
        return 1
    return max(1, min(-(-skv // WG_KV),
                      -(-DQ_SPLIT_BLOCKS_PER_SM * sms // blocks)))


def dq_block_tiles(sq: int, skv: int, r0: int, causal: bool,
                   window: int) -> tuple:
    """The KV tiles [t_lo, t_hi) that the wgmma dQ block of rows r0 ..
    r0 + WG_ROWS walks: those holding a key some row may see (the
    kernel's key_range, rounded out to WG_KV keys)."""
    off = skv - sq
    lo, hi = 0, skv
    if causal:
        hi = min(hi, min(r0 + WG_ROWS, sq) + off)
    if window:
        lo = max(lo, r0 + off - window + 1)
    t_lo = lo // WG_KV
    return t_lo, (-(-hi // WG_KV) if hi > lo else t_lo)


def dq_split_tiles(t_lo: int, t_hi: int, splits: int, split: int) -> tuple:
    """The KV tiles [first, last) of split ``split`` of ``splits``:
    contiguous ranges of ⌈(t_hi − t_lo) / splits⌉ tiles in split order
    (the kernel's split_tiles)."""
    per = -(-(t_hi - t_lo) // splits)
    first = min(t_hi, t_lo + split * per)
    return first, min(t_hi, first + per)


def backward_workspace_bytes(b: int, hq: int, sq: int, d: int, tile,
                             skv: int, sms: int = H100_SMS) -> int:
    """The float32 dQ partials the backward allocates: (S, B, Hq, Sq, d)
    at the wgmma tile's S = `dq_key_splits` > 1, else 0."""
    if tile != "wgmma":
        return 0
    splits = dq_key_splits(b * hq, sq, skv, sms)
    return 0 if splits == 1 else splits * b * hq * sq * d * 4


def _launcher():
    fn = load(SOURCE).flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _backward_launcher():
    fn = load(BACKWARD_SOURCE).flash_attention_backward_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(name, q, k, v):
    """The device, dtype, shape and layout checks of q, k, v that the
    forward and the backward share. Returns (b, hq, hkv, sq, skv, d)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors")
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
    return b, hq, hkv, sq, skv, d


def _bhs_strides(*tensors):
    """The (batch, head, seq) element strides of each tensor, in order."""
    return [st for t in tensors for st in t.stride()[:3]]


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None,
                         return_lse: bool = False):
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d) CUDA tensors of one dtype
    (float32 or bfloat16), head_dim contiguous, any other strides.
    Returns (B, Hq, Sq, d) whose memory is laid out (B, Sq, Hq, d), so the
    caller's merge of heads back into the model width is a view; with
    ``return_lse`` also each row's log-sum-exp of the scaled logits,
    float32 (B, Hq, Sq) (+inf for a row with no key to attend), which the
    backward reads.

    The forward alone: under grad it raises (`_build.refuse_grad`); a
    gradient goes through `ops.FlashAttention`, which calls this with
    grad mode off and saves what `flash_attention_backward_cuda` reads."""
    refuse_grad(NAME, q, k, v)
    b, hq, hkv, sq, skv, d = _check_qkv("flash_attention_cuda", q, k, v)
    if scale is None:
        scale = d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    variant = attention_variant(q.dtype, d, rows_aligned(q, k, v, out))
    status = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *_bhs_strides(q, k, v, out),
        b, hq, hkv, sq, skv, d, int(bool(causal)), int(window), float(scale),
        _DTYPE_CODES[q.dtype], _VARIANT_CODES[variant],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(status, f"{NAME}/{variant}")
    count_launch(NAME, variant)
    return (out, lse) if return_lse else out


def flash_attention_backward_cuda(q, k, v, out, lse, dout, *, causal: bool,
                                  window: int, scale: float,
                                  tile: str | None = None):
    """(dq, dk, dv) of ``out = softmax(q kᵀ · scale + mask) v`` for GQA, in
    one launch of the backward kernel (passes on the current stream:
    rowsum(dO∘O), dK and dV, dQ, and the sum of the dQ key splits where
    the wgmma tile has several) through the variant
    `attention_backward_variant` picks and, for tensor_core, the tile
    `attention_backward_tile` picks (``tile`` names one of that variant's
    tiles instead, for timing them against each other).

    q, out, dout: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d): CUDA tensors of
    one dtype (float32 or bfloat16), head_dim contiguous, any other
    strides; lse: the forward's float32 (B, Hq, Sq) row log-sum-exp
    (`flash_attention_cuda(..., return_lse=True)`), contiguous. The
    gradients come back in the inputs' dtype and in the layouts of q, k
    and v (`torch.empty_like`); deterministic: two calls are bitwise
    equal. Raises when a gradient of this call is wanted
    (`_build.refuse_grad`): the kernel has no backward of its own."""
    refuse_grad(BACKWARD, q, k, v, out, lse, dout)
    b, hq, hkv, sq, skv, d = _check_qkv("flash_attention_backward_cuda",
                                        q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape \
                or t.stride(3) != 1:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}: need q's {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}, head_dim "
                             f"contiguous")
    if lse.device != q.device or lse.dtype != torch.float32 \
            or lse.shape != (b, hq, sq) or not lse.is_contiguous():
        raise ValueError(f"lse {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}: need contiguous float32 "
                         f"{(b, hq, sq)} on {q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    aligned = rows_aligned(q, k, v, out, dout, dq, dk, dv)
    variant = attention_backward_variant(q.dtype, d, aligned)
    picked = attention_backward_tile(q.dtype, d, aligned, sq, skv)
    if tile is None:
        tile = picked
    elif variant != "tensor_core" or tile not in BACKWARD_TILES:
        raise ValueError(f"tile {tile!r} is not a tile of the {variant} "
                         f"variant (tensor_core: {BACKWARD_TILES})")
    splits = 1
    work = None
    if tile == "wgmma":
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = dq_key_splits(b * hq, sq, skv, sms)
        if splits > 1:
            work = torch.empty((splits, b, hq, sq, d), dtype=torch.float32,
                               device=q.device)
    strides = _bhs_strides(q, k, v, out, dout, dq, dk, dv)
    stride_arr = (ctypes.c_int64 * len(strides))(*strides)  # alive for the call
    status = _backward_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        ctypes.addressof(stride_arr),
        b, hq, hkv, sq, skv, d, int(bool(causal)), int(window), float(scale),
        _DTYPE_CODES[q.dtype], _VARIANT_CODES[variant],
        _TILE_CODES.get(tile, 0), splits,
        None if work is None else work.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(status, f"{BACKWARD}/{variant}{f'/{tile}' if tile else ''}")
    count_launch(BACKWARD, variant, tile)
    return dq, dk, dv
