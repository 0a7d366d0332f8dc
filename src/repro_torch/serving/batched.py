"""Batched edge/cloud serving runtime — the vectorized production path.

The stream is served in micro-batches of B samples:

  1. **ingest** — `data.stream.microbatches` groups the sample stream;
  2. **select** — `SplitEEController.choose_splits` draws all B arms from
     the bandit state frozen at the batch boundary (delayed feedback);
  3. **edge** — samples are bucketed by chosen depth and each bucket is
     one `edge_fn`/`edge_fn_s` call, its rows padded to a power of two
     by repeating the last row (the reference pads so XLA compiles few
     shapes; the port keeps the padding so launches, outputs and byte
     accounting match it). With ``edge_mode="scan"`` this step is
     `serving.scan_edge._edge_phase_scan`: one masked forward through all
     L layers for the whole micro-batch; ``"auto"`` picks per batch;
  4. **cloud** — non-exiting rows land in an `OffloadQueue`, kept on the
     device as tensors; at the batch boundary the queue flushes one
     `cloud_fn` call per depth bucket (again pow2-padded), through the
     offload codec when one is set. `flush_async` only queues the calls;
     the sharded runtime (serving/sharded.py) reads them back up to K
     batches later;
  5. **update** — `SplitEEController.update_batch` folds the batch.

With B = 1 the pipeline makes the same decisions as the sequential
runtime; with B > 1 the policy is UCB with feedback delayed by up to B-1
rounds.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import torch_dtype
from repro_torch.core.controller import SplitEEController
from repro_torch.core.rewards import CostModel
from repro_torch.data.stream import microbatches
from repro_torch.serving.offload_codec import OffloadCodec
from repro_torch.serving.simulator import EdgeCloudRuntime


def _pow2(k: int) -> int:
    """Smallest power of two >= k."""
    return 1 << (k - 1).bit_length() if k > 1 else 1


def _bucket_cap(k: int, multiple: int = 1) -> int:
    """Bucket row capacity: pow2-padded, rounded up to `multiple`.

    `multiple` is the sharded runtime's replica count: the cap must
    divide over the mesh's data axis or `sanitize_spec` falls back to
    one call on one replica. With `multiple` = 1 this is `_pow2`.
    """
    cap = max(_pow2(k), multiple)
    return -(-cap // multiple) * multiple


def _as_is(x):
    """Default placement of a launch's input: none (the runtime moves its
    inputs to its device)."""
    return x


def _offload_scale(codec: Optional[OffloadCodec],
                   runtime: EdgeCloudRuntime, seq_len: int) -> float:
    """Scale on the bandit's communication term: wire bytes over
    full-dtype activation bytes (1.0 without a codec)."""
    if codec is None:
        return 1.0
    cfg = runtime.cfg
    return codec.cost_ratio(seq_len, cfg.d_model,
                            torch_dtype(cfg.dtype).itemsize)


def _pad_rows(arr, cap: int):
    """Pad the leading axis to `cap` rows by repeating the last row
    (numpy array or tensor)."""
    k = arr.shape[0]
    if k == cap:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand(cap - k, *arr.shape[1:])])
    return np.concatenate([arr, np.repeat(arr[-1:], cap - k, axis=0)])


class PendingFlush:
    """Cloud launches of one `OffloadQueue.flush_async`, not yet read back.

    Holds the device tensors the `cloud_fn` calls returned (the launches
    are queued on the stream); ``resolve()`` copies them to the host and
    returns ``{slot: (conf_L, pred_L)}``. ``slot_bytes`` holds the wire
    bytes each offloaded slot shipped.
    """

    def __init__(self, launches, slot_bytes: Optional[Dict[int, int]] = None):
        self._launches = launches        # [(slots, conf, pred)] depth order
        self._result: Optional[Dict[int, tuple]] = None
        self.slot_bytes: Dict[int, int] = slot_bytes or {}

    def __len__(self):
        if self._result is not None:
            return len(self._result)
        return sum(len(slots) for slots, _, _ in self._launches)

    @property
    def resolved(self) -> bool:
        return self._result is not None

    def resolve(self) -> Dict[int, tuple]:
        if self._result is None:
            out: Dict[int, tuple] = {}
            for slots, conf_dev, pred_dev in self._launches:
                conf_np = conf_dev.cpu().numpy()
                pred_np = pred_dev.cpu().numpy()
                for j, slot in enumerate(slots):
                    out[slot] = (float(conf_np[j]), int(pred_np[j]))
            self._result = out
            self._launches = []
        return self._result


class OffloadQueue:
    """Accumulates offloaded activations; flushes batched cloud calls.

    Rows stay on the device as (S, D) tensors (the reference keeps host
    numpy copies; a bfloat16 tensor has no numpy dtype, and the cloud
    half runs on the same device). `flush_async()` issues one `cloud_fn`
    call per distinct depth with its rows stacked and pow2-padded; with a
    ``codec`` the padded stack is encoded to the wire format and the cloud
    gets the lossy decode. It returns a `PendingFlush` without reading the
    results back; with ``depth=K`` the queue keeps a ring of in-flight
    flushes and resolves the oldest once more than K are outstanding.
    ``flush()`` is ``flush_async().resolve()``.

    ``put`` places each padded stack for its call: the sharded runtime
    passes a split of the rows over its replicas (`sharded._data_put`);
    by default the stack goes as it is.
    """

    def __init__(self, runtime: EdgeCloudRuntime, params, *, put=None,
                 codec: Optional[OffloadCodec] = None):
        self.runtime = runtime
        self.params = params
        self.put = put if put is not None else _as_is
        self.codec = codec
        self.rows: Dict[int, List[torch.Tensor]] = {}   # depth -> [(S, D)]
        self.slots: Dict[int, List[int]] = {}
        self.inflight: List[PendingFlush] = []        # flush_async ring

    def add_rows(self, depth: int, hidden_rows: torch.Tensor,
                 slots: List[int]):
        """hidden_rows: (k, S, D), one row per queued sample."""
        self.rows.setdefault(depth, []).extend(hidden_rows)
        self.slots.setdefault(depth, []).extend(slots)

    def __len__(self):
        return sum(len(v) for v in self.slots.values())

    def flush_async(self, *, min_rows: int = 1,
                    depth: Optional[int] = None) -> PendingFlush:
        """Queue one `cloud_fn` call per queued depth; don't read back.

        ``min_rows`` sets the pad floor and rounding multiple (the sharded
        runtime passes its replica count). ``depth`` bounds the flush
        pipeline: the returned `PendingFlush` joins a ring of in-flight
        flushes, and once more than ``depth`` are unresolved the oldest is
        resolved, FIFO (``resolve`` is idempotent, so that is the one the
        caller would have resolved next). ``None`` leaves the ring
        unbounded (the caller owns resolution).
        """
        if depth is not None and depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        launches = []
        slot_bytes: Dict[int, int] = {}
        for d in sorted(self.rows):
            slots, rows = self.slots[d], self.rows[d]
            # rows made by several replicas' devices meet on the first's
            dev = rows[0].device
            if any(r.device != dev for r in rows):
                rows = [r.to(dev) for r in rows]
            hidden = _pad_rows(torch.stack(rows),
                               _bucket_cap(len(slots), min_rows))
            if self.codec is not None:
                enc = self.codec.encode(hidden)
                hidden = self.codec.decode(enc)
                rb = enc.row_bytes
            else:
                rb = hidden[0].numel() * hidden.element_size()
            conf_L, pred_L = self.runtime.cloud_fn(self.params,
                                                   self.put(hidden), d)
            launches.append((list(slots), conf_L, pred_L))
            for s in slots:
                slot_bytes[s] = rb
        self.rows.clear()
        self.slots.clear()
        pending = PendingFlush(launches, slot_bytes)
        if depth is not None:
            self.inflight = [p for p in self.inflight if not p.resolved]
            self.inflight.append(pending)
            while len(self.inflight) > depth:
                self.inflight.pop(0).resolve()
        return pending

    def flush(self) -> Dict[int, tuple]:
        return self.flush_async().resolve()


def _edge_phase(runtime: EdgeCloudRuntime, params, tokens: np.ndarray,
                arms: np.ndarray, cost: CostModel, queue: OffloadQueue, *,
                side_info: bool, put=_as_is, replicas: int = 1):
    """One micro-batch's edge pass: one call per distinct depth. Samples
    that don't exit are queued on ``queue``; returns (conf_paths,
    batch_preds) indexed by batch slot.

    Shared by the batched and sharded runtimes, which differ only in the
    placement of each call's rows (``put``) and the bucket-cap rounding
    multiple (``replicas``)."""
    B = len(arms)
    conf_paths: List[Optional[np.ndarray]] = [None] * B
    batch_preds = [0] * B
    for arm in np.unique(arms):
        arm = int(arm)
        idx = np.nonzero(arms == arm)[0]
        toks = _pad_rows(tokens[idx], _bucket_cap(len(idx), replicas))
        jb = {"tokens": put(toks)}
        if side_info:
            conf_all, pred_all, hidden = runtime.edge_fn_s(params, jb, arm)
            conf_np = conf_all.cpu().numpy()                 # (L, cap)
            pred_np = pred_all.cpu().numpy()
            for j, s in enumerate(idx):
                conf_paths[s] = conf_np[: arm + 1, j]
                batch_preds[s] = int(pred_np[arm, j])
        else:
            conf_v, pred_v, hidden = runtime.edge_fn(params, jb, arm)
            conf_np = conf_v.cpu().numpy()                   # (cap,)
            pred_np = pred_v.cpu().numpy()
            for j, s in enumerate(idx):
                conf_paths[s] = conf_np[j:j + 1]
                batch_preds[s] = int(pred_np[j])
        keep_j = [j for j, s in enumerate(idx)
                  if not (float(conf_paths[s][-1]) >= cost.alpha
                          or arm + 1 == cost.num_layers)]
        if keep_j:
            queue.add_rows(arm, hidden[keep_j], [int(idx[j]) for j in keep_j])
    return conf_paths, batch_preds


class _BatchedSession:
    """Incremental driver of the batched micro-batch schedule: one
    `push(batch)` runs select -> edge -> cloud flush -> delayed-feedback
    fold, so the one-shot `_serve_stream_batched` and the push-mode
    `api.Engine` are the same machinery; `result()` reports without
    ending the session."""

    def __init__(self, runtime: EdgeCloudRuntime, params, cost: CostModel,
                 *, batch_size: int = 32, side_info: bool = False,
                 beta: float = 1.0, labels_for_accounting: bool = True,
                 record_trace: bool = False, edge_mode: str = "bucketed",
                 controller_kwargs: Optional[Dict[str, Any]] = None,
                 codec: Optional[OffloadCodec] = None):
        # lazy import: scan_edge imports OffloadQueue/_pad_rows from here
        from repro_torch.serving.scan_edge import select_edge_phase
        self.runtime = runtime
        self.params = params
        self.cost = cost
        self.batch_size = batch_size
        self.side_info = side_info
        self.edge_mode = edge_mode
        self._edge_phase = select_edge_phase(edge_mode)
        self.labels_for_accounting = labels_for_accounting
        self.ctl = SplitEEController(cost, beta=beta, side_info=side_info,
                                     **(controller_kwargs or {}))
        self.codec = codec
        self.queue = OffloadQueue(runtime, params, codec=codec)
        self.correct: List[int] = []
        self.preds: List[int] = []
        self.trace: Optional[Dict[str, list]] = (
            {"conf_path": [], "conf_L": []} if record_trace else None)
        self.n = 0

    def push(self, batch):
        """Serve one micro-batch (any size >= 1); an empty push is a no-op
        (a scheduler tick that formed nothing spends no bandit round)."""
        if not batch:
            return
        B = len(batch)
        arms = self.ctl.choose_splits(B)
        tokens = np.stack([np.asarray(s["tokens"]) for s in batch])
        seq_len = tokens.shape[1]

        conf_paths, batch_preds = self._edge_phase(
            self.runtime, self.params, tokens, arms, self.cost, self.queue,
            side_info=self.side_info)

        pending = self.queue.flush_async()
        cloud = pending.resolve()
        conf_Ls: List[Optional[float]] = [None] * B
        obs = [0] * B
        for s, (c_L, p_L) in cloud.items():
            conf_Ls[s] = c_L
            batch_preds[s] = p_L
            obs[s] = pending.slot_bytes[s]

        self.ctl.update_batch(
            arms, conf_paths, conf_Ls, obs,
            offload_scale=_offload_scale(self.codec, self.runtime, seq_len))

        self.preds.extend(batch_preds)
        if self.trace is not None:
            self.trace["conf_path"].extend(conf_paths)
            self.trace["conf_L"].extend(conf_Ls)
        if self.labels_for_accounting:
            for s, sample in enumerate(batch):
                if "labels" in sample:
                    self.correct.append(
                        int(batch_preds[s] == int(sample["labels"])))
        self.n += B

    def drain(self):
        """Nothing is in flight: every flush resolves at its own batch
        boundary (the sharded session's drain resolves its ring)."""

    def result(self) -> Dict[str, Any]:
        ctl = self.ctl
        hist = {k: np.asarray(v) for k, v in ctl.history.items()}
        tot = ctl.totals
        out = {
            "n": self.n,
            "batch_size": self.batch_size,
            "preds": np.asarray(self.preds),
            "cost_total": float(tot["cost"]),
            "offload_frac": (1.0 - tot["exited"] / tot["served"]
                             if tot["served"] else 0.0),
            "offload_bytes": int(tot["offload_bytes"]),
            "arms": hist["arm"],
            "rewards": hist["reward"],
            "exited": hist["exited"],
            "state": ctl.snapshot(),
        }
        if self.correct:
            out["accuracy"] = float(np.mean(self.correct))
        if self.trace is not None:
            out["trace"] = self.trace
        return out


def _serve_stream_batched(runtime: EdgeCloudRuntime, params, stream,
                          cost: CostModel, *, batch_size: int = 32,
                          side_info: bool = False, beta: float = 1.0,
                          max_samples: int = 0,
                          labels_for_accounting: bool = True,
                          record_trace: bool = False,
                          edge_mode: str = "bucketed",
                          controller_kwargs: Optional[Dict[str, Any]] = None,
                          codec: Optional[OffloadCodec] = None,
                          ) -> Dict[str, Any]:
    """Offline driver: replay a finite stream through a batched session."""
    sess = _BatchedSession(runtime, params, cost, batch_size=batch_size,
                           side_info=side_info, beta=beta,
                           labels_for_accounting=labels_for_accounting,
                           record_trace=record_trace, edge_mode=edge_mode,
                           controller_kwargs=controller_kwargs, codec=codec)
    for batch in microbatches(stream, batch_size, max_samples):
        sess.push(batch)
    return sess.result()

