"""Quantized-bottleneck codec for the edge->cloud offload payload.

The wire format the offload queue applies at flush time, with the
reference codec's arithmetic step for step, in torch ops on the rows'
own device (the rows are device tensors, often bfloat16, which has no
numpy dtype):

* **per-channel affine quantization** (``int8`` or ``int4``): for each
  offloaded row ``(S, D)``, per-channel ``scale``/``zero`` (f32 each) are
  fit over the sequence axis, values are rounded half-to-even to the
  integer grid (int4 packs two values per byte), and the cloud side
  dequantizes before running the remaining layers.
* **top-k sparsification** (``sparsity`` = fraction of entries DROPPED):
  keeps the largest-|x| entries per row (stable order: equal magnitudes
  keep the lowest flat index) and ships their int32 flat indices beside
  the kept values; dropped entries decode to exactly 0.0. Composes with
  quantization (sparsify-then-quantize).

Every division takes two tensors, so no device turns a division by a
constant into a multiplication by its reciprocal, and each arithmetic
step is rounded on its own as numpy rounds it: the decoded rows are
bitwise those of the reference's numpy codec, on the CPU and on a GPU.
``row_bytes``/``cost_ratio`` are exact closed forms for the wire size,
deterministic per shape. The identity config (``quant="none"``,
``sparsity=0.0``) is no codec at all (`codec_from_fields` returns None).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

QUANT_MODES = ("none", "int8", "int4")

_QRANGE = {"int8": (-128, 127), "int4": (-8, 7)}
_SCALE_ZERO_BYTES = 8   # per channel: f32 scale + f32 zero-point
_INDEX_BYTES = 4        # int32 flat index per kept entry (sparse only)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an f32 tensor on ``like``'s device (a tensor operand,
    never a Python scalar, keeps a division a true division)."""
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(k, m) int8 in [-8, 7] -> (k, ceil(m/2)) uint8, two nibbles/byte."""
    k, m = q.shape
    u = (q.to(torch.int16) + 8).to(torch.uint8)          # [0, 15]
    if m % 2:
        u = torch.cat([u, torch.zeros((k, 1), dtype=torch.uint8,
                                      device=u.device)], dim=1)
    return u[:, 0::2] | (u[:, 1::2] << 4)


def _unpack_int4(data: torch.Tensor, m: int) -> torch.Tensor:
    u = torch.stack([data & 0x0F, data >> 4], dim=2).reshape(
        data.shape[0], -1)
    return u[:, :m].to(torch.int16) - 8


@dataclasses.dataclass
class EncodedRows:
    """Wire-format payload for a stack of offloaded rows, on their device.

    ``data`` holds the kept values (original dtype for quant="none", int8,
    or int4-packed uint8); ``scale``/``zero`` the per-row per-channel
    affine params; ``index`` the per-row int32 flat indices of kept
    entries (None when dense).
    """
    codec: "OffloadCodec"
    shape: Tuple[int, int, int]          # (rows, seq_len, d_model)
    dtype: torch.dtype                   # dtype to decode back to
    data: torch.Tensor
    scale: Optional[torch.Tensor] = None   # (rows, D) f32
    zero: Optional[torch.Tensor] = None    # (rows, D) f32
    index: Optional[torch.Tensor] = None   # (rows, kept) i32

    @property
    def row_bytes(self) -> int:
        """Measured wire bytes per row (values + affine params + indices)."""
        k = self.shape[0]
        return (_nbytes(self.data) // k
                + (_nbytes(self.scale) + _nbytes(self.zero)) // k
                + _nbytes(self.index) // k)

    @property
    def nbytes(self) -> int:
        return self.row_bytes * self.shape[0]


@dataclasses.dataclass(frozen=True)
class OffloadCodec:
    """quant in {"none", "int8", "int4"}; sparsity = fraction dropped.

    ``error_feedback`` opts into the EF-SGD-style compensation loop for
    sequences that offload repeatedly: the caller keeps a per-sequence
    residual and calls :meth:`encode_with_feedback`. The codec itself is
    stateless.
    """
    quant: str = "none"
    sparsity: float = 0.0
    error_feedback: bool = False

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(
                f"OffloadCodec quant={self.quant!r} is unknown; choose one "
                f"of {QUANT_MODES}")
        if not 0.0 <= self.sparsity < 1.0:
            raise ValueError(
                f"OffloadCodec sparsity={self.sparsity!r} out of range; "
                f"need 0.0 <= sparsity < 1.0 (fraction of entries dropped)")

    @property
    def identity(self) -> bool:
        return self.quant == "none" and self.sparsity == 0.0

    def kept(self, seq_len: int, d_model: int) -> int:
        total = seq_len * d_model
        if self.sparsity == 0.0:
            return total
        return max(1, total - int(round(self.sparsity * total)))

    def row_bytes(self, seq_len: int, d_model: int, itemsize: int) -> int:
        """Exact wire bytes for one (S, D) row (equal to the measured
        ``EncodedRows.row_bytes``)."""
        total = seq_len * d_model
        k = self.kept(seq_len, d_model)
        if self.quant == "none":
            out = k * itemsize
        elif self.quant == "int8":
            out = k + _SCALE_ZERO_BYTES * d_model
        else:  # int4
            out = (k + 1) // 2 + _SCALE_ZERO_BYTES * d_model
        if k < total:
            out += _INDEX_BYTES * k
        return out

    def cost_ratio(self, seq_len: int, d_model: int, itemsize: int) -> float:
        """Wire bytes over full-dtype activation bytes — the factor the
        controller applies to the paper's communication cost ``o``."""
        return (self.row_bytes(seq_len, d_model, itemsize)
                / float(seq_len * d_model * itemsize))

    # ------------------------------------------------------------- encode

    def encode(self, rows: torch.Tensor) -> EncodedRows:
        """rows: (k, S, D) activations -> wire payload on their device."""
        k, s, d = rows.shape
        dtype = rows.dtype
        x = rows.to(torch.float32)
        total = s * d
        kept = self.kept(s, d)
        index = None
        if kept < total:
            flat = x.reshape(k, total)
            # largest |x| first; a stable sort keeps equal magnitudes in
            # flat-index order (abs maps -0.0 to +0.0, so zeros tie)
            order = torch.sort(flat.abs(), dim=1, descending=True,
                               stable=True).indices
            index = torch.sort(order[:, :kept], dim=1).values.to(torch.int32)
            mask = torch.zeros((k, total), dtype=torch.bool, device=x.device)
            mask.scatter_(1, index.long(), True)
            x = torch.where(mask, flat, _const(0.0, flat)).reshape(k, s, d)
        if self.quant == "none":
            if index is None:
                return EncodedRows(self, (k, s, d), dtype, rows.clone())
            vals = torch.gather(x.reshape(k, total), 1,
                                index.long()).to(dtype)
            return EncodedRows(self, (k, s, d), dtype, vals, index=index)
        qmin, qmax = _QRANGE[self.quant]
        xmin = x.amin(dim=1)                                 # (k, D)
        xmax = x.amax(dim=1)
        scale = (xmax - xmin) / _const(qmax - qmin, x)
        scale = torch.where(scale > 0.0, scale, _const(1.0, x))
        zero = _const(qmin, x) - xmin / scale
        q = torch.round(x / scale[:, None, :] + zero[:, None, :])
        q = q.clamp(qmin, qmax).to(torch.int8).reshape(k, total)
        if index is not None:
            q = torch.gather(q, 1, index.long())             # (k, kept)
        data = _pack_int4(q) if self.quant == "int4" else q
        return EncodedRows(self, (k, s, d), dtype, data,
                           scale=scale, zero=zero, index=index)

    def encode_with_feedback(self, rows: torch.Tensor,
                             residual: torch.Tensor):
        """Error-feedback encode: fold the residual the previous round
        dropped into this round's input, encode, and return
        ``(enc, decoded, new_residual)`` with ``new_residual = (rows +
        residual) - decoded`` in f32."""
        x = rows.to(torch.float32) + residual.to(torch.float32)
        enc = self.encode(x.to(rows.dtype))
        decoded = self.decode(enc)
        return enc, decoded, x - decoded.to(torch.float32)

    # ------------------------------------------------------------- decode

    def decode(self, enc: EncodedRows) -> torch.Tensor:
        """Wire payload -> (k, S, D) in the original dtype (dropped
        entries exactly 0.0; quantized entries ``(q - zero) * scale``)."""
        k, s, d = enc.shape
        total = s * d
        dev = enc.data.device
        kept = enc.index.shape[1] if enc.index is not None else total
        if self.quant == "none":
            if enc.index is None:
                return enc.data.clone()
            flat = torch.zeros((k, total), dtype=torch.float32, device=dev)
            flat.scatter_(1, enc.index.long(), enc.data.to(torch.float32))
            return flat.reshape(k, s, d).to(enc.dtype)
        if self.quant == "int4":
            q = _unpack_int4(enc.data, kept).to(torch.float32)
        else:
            q = enc.data.to(torch.float32)
        if enc.index is None:
            x = ((q.reshape(k, s, d) - enc.zero[:, None, :])
                 * enc.scale[:, None, :])
        else:
            ch = (enc.index % d).long()          # channel of each kept entry
            vals = ((q - torch.gather(enc.zero, 1, ch))
                    * torch.gather(enc.scale, 1, ch))
            flat = torch.zeros((k, total), dtype=torch.float32, device=dev)
            flat.scatter_(1, enc.index.long(), vals)
            x = flat.reshape(k, s, d)
        return x.to(enc.dtype)


def codec_from_fields(quant: str, sparsity: float,
                      error_feedback: bool = False
                      ) -> Optional[OffloadCodec]:
    """None for the identity config, so callers keep the codec-free path."""
    if quant == "none" and sparsity == 0.0:
        return None
    return OffloadCodec(quant=quant, sparsity=sparsity,
                        error_feedback=error_feedback)
