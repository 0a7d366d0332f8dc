"""Decode-state manager: per-sequence cache consistency + offload accounting.

The decode runtime makes a per-token SplitEE decision at the bandit's
splitting layer, which creates two cache-consistency obligations the
classifier stream never had:

* **Early exit at layer ℓ** — layers > ℓ must not advance their cache
  slots for that step. A skipped attention layer leaves its ring slot for
  this step unwritten, and the ``pos`` validity mask (``pos >= 0 & pos <=
  cur_index``) excludes the hole at every later read, so ``cur_index``
  stays the global step for all layers and RoPE positions stay global.
  Recurrent states (rwkv6) are frozen with a per-sample ``torch.where``.
  Both happen inside ``transformer.decode_step_masked``; this manager owns
  the resulting cache tree and the realized-depth ledger.

* **Mid-generation offload** — the edge ships the split-layer hidden
  through the :class:`OffloadCodec` (a real encode/decode round trip on
  the rows' device: the cloud computes on the reconstruction) plus the
  per-step ≤ℓ cache-slice update at raw bytes. The cloud half
  (``decode_step_resume``) advances only layers > ℓ of offloaded samples
  and passes everything else through bitwise, so committing its tree IS
  the edge re-sync.

Wire accounting is closed-form: ``step_slice_bytes`` prices the per-step
cache slice from a one-slot cache template built on the ``meta`` device
(nothing is allocated: attention, one K/V slot + 4 pos bytes a layer;
ssm, the whole recurrent state a layer, priced float32 as
``init_rwkv_state`` makes it; hybrid, the Mamba2 state every layer plus
one shared-attention slot at each k-th layer, the only layers that write
one), and ``offload_scale_vec`` turns that into
the per-arm wire/raw ratio the controller folds into the paper's
communication term ``o``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.serving.offload_codec import OffloadCodec


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    for val in tree.values():
        out.extend(_leaves(val) if isinstance(val, dict) else [val])
    return out


def per_step_layer_bytes(cfg: ModelConfig) -> np.ndarray:
    """(L,) bytes each layer adds to its cache per decode step, from a
    one-token cache template on the meta device (``seq_len=1`` makes the
    attention window exactly one slot). Every layer writes its ``ssm``
    entry; the ``attn`` slot is written by every layer, except in a
    hybrid, where only the layers after which the shared block runs
    (every k-th) write one."""
    from repro_torch.models import transformer
    tree = transformer.init_caches(cfg, 1, 1, device="meta")

    def per(key):
        return sum(int(np.prod(leaf.shape[1:])) * leaf.element_size()
                   for leaf in _leaves(tree.get(key, {})))

    out = np.full(cfg.num_layers, per("ssm"), np.int64)
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        out[np.arange(cfg.num_layers) % k == k - 1] += per("attn")
    else:
        out += per("attn")
    return out


def step_slice_bytes(cfg: ModelConfig, depth: int) -> int:
    """Wire bytes of the per-step cache updates for layers 0..depth — the
    slice an offload at split ``depth`` ships so the cloud's copy of the
    edge-computed layers is current."""
    return int(np.cumsum(per_step_layer_bytes(cfg))[depth])


def hidden_raw_bytes(cfg: ModelConfig) -> int:
    """Full-dtype bytes of the (1, D) split-layer hidden payload."""
    return cfg.d_model * torch_dtype(cfg.dtype).itemsize


def offload_scale_vec(cfg: ModelConfig,
                      codec: Optional[OffloadCodec]) -> np.ndarray:
    """(L,) per-arm wire/raw byte ratio for the bandit's communication
    term: arm i offloads ``codec(hidden) + slice(≤i)`` wire bytes against a
    raw price of ``hidden + slice(≤i)``. All-ones without a codec."""
    slice_b = np.cumsum(per_step_layer_bytes(cfg)).astype(np.float64)
    raw_h = float(hidden_raw_bytes(cfg))
    if codec is None:
        wire_h = raw_h
    else:
        wire_h = float(codec.row_bytes(1, cfg.d_model,
                                       torch_dtype(cfg.dtype).itemsize))
    return (wire_h + slice_b) / (raw_h + slice_b)


class DecodeCacheManager:
    """Owns one push-batch's decode cache tree and its consistency ledger.

    The tree itself is advanced by ``decode_step_masked`` (edge) and
    ``decode_step_resume`` (cloud re-sync), both returning whole trees
    that equal their input bitwise wherever they did not advance; the
    manager commits them, logs the realized depths and offload decisions
    per step (a replay re-decodes from a fresh cache against this
    ledger), runs the codec round trip with per-sequence error-feedback
    residuals kept on the rows' device, and meters wire bytes.
    """

    def __init__(self, cfg: ModelConfig, caches,
                 codec: Optional[OffloadCodec] = None):
        self.cfg = cfg
        self.caches = caches
        self.codec = codec
        first = _leaves(caches)[0]
        b = int(first.shape[1])
        self.batch = b
        self._slice_cum = np.cumsum(per_step_layer_bytes(cfg))
        self.realized_depths: List[np.ndarray] = []   # (B,) per step
        self.offloaded: List[np.ndarray] = []         # (B,) bool per step
        self.offloads_per_seq = np.zeros(b, np.int64)
        self.wire_bytes_per_seq = np.zeros(b, np.int64)
        self._residual = None
        if codec is not None and codec.error_feedback:
            self._residual = torch.zeros((b, 1, cfg.d_model),
                                         dtype=torch.float32,
                                         device=first.device)

    # ------------------------------------------------------------- commits

    def commit_edge(self, new_caches, depths: np.ndarray):
        self.caches = new_caches
        self.realized_depths.append(np.asarray(depths, np.int64).copy())

    def commit_cloud(self, new_caches, active: np.ndarray):
        """The cloud's tree passes non-active coordinates through bitwise,
        so committing it wholesale re-syncs the edge cache."""
        self.caches = new_caches
        self.offloaded.append(np.asarray(active, bool).copy())

    def note_no_offload(self):
        self.offloaded.append(np.zeros(self.batch, bool))

    # ------------------------------------------------------------ offloads

    def ship_hidden(self, hidden: torch.Tensor, rows: torch.Tensor):
        """Codec round trip for the offloaded samples' split-layer hidden.

        hidden: (B, 1, D) device tensor; rows: index tensor of the
        offloading samples on its device. Returns ``(decoded_rows,
        hidden_wire_bytes_per_row)``: the cloud consumes the decoded
        payload, so codec loss is visible end to end. With
        ``error_feedback`` the per-sequence residual is folded in and
        updated; without a codec this is a copy.
        """
        sel = hidden[rows]
        if self.codec is None:
            return sel, hidden_raw_bytes(self.cfg)
        if self._residual is not None:
            enc, decoded, new_res = self.codec.encode_with_feedback(
                sel, self._residual[rows])
            self._residual[rows] = new_res
        else:
            enc = self.codec.encode(sel)
            decoded = self.codec.decode(enc)
        return decoded.to(hidden.dtype), enc.row_bytes

    def offload_wire_bytes(self, depth: int, hidden_wire: int) -> int:
        """Total metered bytes for one offload at split ``depth``."""
        return int(hidden_wire) + int(self._slice_cum[depth])

    def meter(self, rows: np.ndarray, depths: np.ndarray,
              hidden_wire: int) -> np.ndarray:
        """Per-sample wire bytes for this step's offloads; updates the
        per-sequence ledgers and returns the (len(rows),) byte array."""
        out = np.asarray([self.offload_wire_bytes(int(depths[b]), hidden_wire)
                          for b in rows], np.int64)
        self.offloads_per_seq[rows] += 1
        self.wire_bytes_per_seq[rows] += out
        return out
