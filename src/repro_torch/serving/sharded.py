"""Sharded multi-replica edge/cloud serving — data parallelism over the
mesh's "data" axis, with the cloud flush overlapped against the next
edge batch.

The batched runtime (batched.py) serves on one replica and reads every
cloud flush back at its own batch boundary. This module scales the same
pipeline out and overlaps it:

  * **data-parallel edge/cloud calls** — every depth-bucketed padded call
    (edge buckets and offload-queue cloud flushes) takes its rows split
    over the mesh's "data" axis (`_data_put`; `launch/shardings.py:
    sanitize_spec` guards divisibility, and bucket caps are rounded up to
    a multiple of `replicas` — `batched._bucket_cap` — so they divide). A
    call over R replicas is R calls of the same `EdgeCloudRuntime` half,
    the r-th on replica r's device with replica r's parameters over the
    r-th contiguous chunk of rows (`_ReplicatedRuntime`); confidences and
    predictions are gathered in replica order, hidden rows stay on the
    device that made them. With one replica the call is exactly the
    batched path's one call on the same tensors. Parameters are placed by
    `launch/shardings.py:param_shardings`, which replicates every leaf on
    the 1-D serving mesh; a leaf already on a replica's device is not
    copied (on the CPU the replicas share one tree). A "model" axis would
    split parameters Megatron-style: model parallelism, not ported yet.
  * **per-replica bandit statistics** — each replica owns a contiguous
    shard of the micro-batch; its arms are its slice of the global
    frozen-state selection, and its update statistics are summarized by
    `SplitEEController.prepare_shard_update` and folded by
    `merge_shard_updates` at the batch boundary. The fold replays the
    sequential arithmetic, so the replica count does not change the
    policy.
  * **async offload (depth-K pipeline)** — with ``overlap=True`` the
    batched `cloud_fn` flush for batch t is queued
    (`OffloadQueue.flush_async`, no read-back) and resolved only after up
    to ``overlap_depth`` later batches have selected their arms and
    launched their edge calls. Feedback for batch t lands K batches later
    than in the synchronous path: delay grows from at most B-1 rounds to
    at most (K+1)·B-1 (asserted at every fold). ``overlap_depth=1`` is
    double buffering. All calls go to one CUDA stream, so what overlap
    moves is host work: the read-back of a flush waits until K later
    batches were dispatched, but each edge bucket's own read-back still
    waits for every launch before it. The result records the pipeline
    under ``"overlap"``.

Semantics: with ``replicas=1`` and ``overlap=False`` this path makes the
batched runtime's calls on the same tensors, so its results are
bit-identical to it. Overlap changes *when* updates land (K batches
later); replicas change only *where* compute runs.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.controller import SplitEEController
from repro_torch.core.rewards import CostModel
from repro_torch.data.stream import microbatches
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.launch.shardings import param_shardings, sanitize_spec
from repro_torch.models.transformer import map_tree
from repro_torch.serving.batched import OffloadQueue, _offload_scale
from repro_torch.serving.offload_codec import OffloadCodec
from repro_torch.serving.simulator import EdgeCloudRuntime


def _shard_sizes(total: int, replicas: int) -> List[int]:
    """Contiguous per-replica shard sizes (first shards take the tail)."""
    base, rem = divmod(total, replicas)
    return [base + (1 if r < rem else 0) for r in range(replicas)]


def _data_devices(mesh: ServingMesh) -> List[torch.device]:
    """The devices along the mesh's "data" axis, in replica order."""
    axis = mesh.axis_names.index("data")
    along = np.moveaxis(mesh.devices, axis, 0)
    return list(along.reshape(along.shape[0], -1)[:, 0])


@dataclasses.dataclass
class _Split:
    """One call's row input over the replicas that run it: ``parts[i]``,
    the i-th contiguous chunk of rows, is placed on ``devices[i]``."""
    parts: list
    devices: List[torch.device]


def _data_put(mesh: ServingMesh):
    """Placement closure splitting an array's leading axis over "data".

    A tensor chunk is moved to its replica's device (no copy where it is
    already there); a numpy chunk (token ids, depths) is left for the
    runtime, which moves its inputs to the device it runs on. Where
    `sanitize_spec` falls back to replication (rows that do not divide the
    axis), the call is one call on the axis' first replica."""
    devices = _data_devices(mesh)

    def to(arr, dev):
        return arr.to(dev) if isinstance(arr, torch.Tensor) else arr

    def put(arr):
        spec = sanitize_spec(mesh, ("data",) + (None,) * (arr.ndim - 1),
                             arr.shape)
        if spec[0] is None or len(devices) == 1:
            return _Split([to(arr, devices[0])], devices[:1])
        n = arr.shape[0] // len(devices)
        return _Split([to(arr[i * n:(i + 1) * n], d)
                       for i, d in enumerate(devices)], devices)
    return put


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (a runtime on ``cuda`` puts its
    inputs there); nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class _Rows:
    """Hidden rows gathered from several replicas, each row left on the
    device that made it: ``rows[idx]`` lists the rows at the (global)
    indices ``idx``."""

    def __init__(self, parts: List[torch.Tensor]):
        self._rows = [row for part in parts for row in part.unbind(0)]

    def __getitem__(self, idx):
        return [self._rows[int(i)] for i in idx]


class _ReplicatedRuntime:
    """`EdgeCloudRuntime`'s halves over the replicas of a data mesh.

    Each half takes its row input as a `_Split` (from `_data_put`) and the
    per-replica parameter trees (``params[i]`` on ``devices[i]``). It runs
    the runtime's half once per part, on that part's device with that
    replica's tree, and gathers the outputs in replica order:
    confidences and predictions concatenated on the first part's device,
    hidden rows left where they were made (`_Rows`). With one part the
    half's own outputs come back untouched: one call, no copy."""

    def __init__(self, runtime: EdgeCloudRuntime):
        self.runtime = runtime

    def _map(self, fn, params, splits, row_dims):
        """``fn(params_i, *parts_i)`` for every part; ``row_dims`` gives the
        row axis of each output (None: hidden rows)."""
        first = splits[0]
        if len(first.parts) == 1:
            return fn(params[0], *(s.parts[0] for s in splits))
        outs = []
        for i, dev in enumerate(first.devices):
            with _on(dev):
                outs.append(fn(params[i], *(s.parts[i] for s in splits)))
        home = first.devices[0]
        return tuple(
            _Rows([o[k] for o in outs]) if dim is None
            else torch.cat([o[k].to(home) for o in outs], dim)
            for k, dim in enumerate(row_dims))

    def edge_fn(self, params, batch, depth: int):
        return self._map(
            lambda p, t: self.runtime.edge_fn(p, {"tokens": t}, depth),
            params, (batch["tokens"],), (0, 0, None))

    def edge_fn_s(self, params, batch, depth: int):
        return self._map(
            lambda p, t: self.runtime.edge_fn_s(p, {"tokens": t}, depth),
            params, (batch["tokens"],), (1, 1, None))

    def edge_scan_fn(self, params, batch, depths):
        return self._map(
            lambda p, t, d: self.runtime.edge_scan_fn(p, {"tokens": t}, d),
            params, (batch["tokens"], depths), (1, 1, None))

    def cloud_fn(self, params, hidden, depth: int):
        return self._map(
            lambda p, h: self.runtime.cloud_fn(p, h, depth),
            params, (hidden,), (0, 0))


def _replicate_params(mesh: ServingMesh, params, runtime: EdgeCloudRuntime,
                      devices: List[torch.device]) -> list:
    """One parameter tree per data replica, placed by `param_shardings`.

    On the 1-D serving mesh every leaf replicates, so each replica holds
    the whole tree; a tree already on a replica's device is that
    replica's tree, uncopied. A mesh with a "model" axis splits leaves
    Megatron-style, which is model parallelism and raises; so do mesh
    devices of another kind than the runtime's and the parameters'."""
    home = params["embed"].device
    kinds = {d.type for d in devices}
    if kinds != {runtime.device.type} or home.type != runtime.device.type:
        raise ValueError(
            f"mesh devices {[str(d) for d in devices]} do not match the "
            f"runtime's device {runtime.device} and the parameters' "
            f"{home}")
    amap = {"model": "model" if "model" in mesh.axis_names else None,
            "fsdp": None}
    split = []
    map_tree(lambda s: split.append(s) if not s.replicated else None,
             param_shardings(mesh, params, axis_map=amap))
    if split:
        raise NotImplementedError(
            f"the mesh's axes {mesh.axis_names} split {len(split)} "
            f"parameter leaves (a 'model' axis places them Megatron-style): "
            f"model parallelism is not ported yet; serve over a 1-D "
            f"('data',) mesh")

    held = set()
    map_tree(lambda t: held.add(t.device), params)
    return [params if held == {dev} else map_tree(lambda t: t.to(dev), params)
            for dev in devices]


@dataclasses.dataclass
class _BatchCtx:
    """Everything finalization needs once the cloud flush resolves."""
    arms: np.ndarray
    conf_paths: List[Optional[np.ndarray]]
    batch_preds: List[int]
    labels: List[Optional[int]]
    seq_len: int
    pending: Any                      # PendingFlush
    start: int = 0                    # global round index of first sample
    overlapped: bool = False


class _PipelineDriver:
    """The depth-K serving schedule, incremental form: ``process_batch(
    batch, start)`` selects arms and dispatches one micro-batch's edge
    work + cloud flush (returning its _BatchCtx), up to ``overlap_depth``
    contexts stay in flight, and ``finalize`` folds them FIFO. Asserts
    the feedback-delay bound <= (K+1)*B - 1 at every fold.

    ``push`` serves one micro-batch; ``drain`` folds the remaining ring.
    The offline entry point wraps this in `_drive_pipeline`; the
    push-mode `api.Engine` drives it one submit at a time — same object,
    same schedule, which is what makes the two bit-identical.

    The in-flight bound holds at two levels with the same K: this deque
    bounds *fold order* (controller updates land FIFO), while the queue's
    ``flush_async(depth=K)`` ring bounds the flushes that are not read
    back. Both resolve the same PendingFlush objects FIFO and ``resolve``
    is idempotent, so the results are the same whichever fires first.
    """

    def __init__(self, *, batch_size: int, overlap: bool,
                 overlap_depth: int, process_batch, finalize):
        self.batch_size = batch_size
        self.overlap = overlap
        self.overlap_depth = overlap_depth
        self.process_batch = process_batch
        self.finalize = finalize
        self.inflight: collections.deque[_BatchCtx] = collections.deque()
        self.selected = 0              # arms drawn so far (global rounds)
        self.batches = 0

    def _fold(self, ctx: _BatchCtx):
        # feedback-delay bound: the oldest sample of this batch has seen
        # at most (K+1)*B - 1 later selections before its update lands.
        depth_eff = self.overlap_depth if self.overlap else 0
        bound = (depth_eff + 1) * self.batch_size - 1
        assert self.selected - 1 - ctx.start <= bound, (
            f"feedback delay {self.selected - 1 - ctx.start} exceeds "
            f"(K+1)*B-1 = {bound}")
        self.finalize(ctx)

    def push(self, batch):
        ctx = self.process_batch(batch, self.selected)
        self.selected += len(batch)
        self.batches += 1
        if self.overlap:
            # depth-K pipeline: cloud calls from the last up-to-K batches
            # stay unread behind this batch's edge phase; once the ring is
            # full the oldest resolves and folds.
            self.inflight.append(ctx)
            while len(self.inflight) > self.overlap_depth:
                oldest = self.inflight.popleft()
                oldest.overlapped = True
                self._fold(oldest)
        else:
            self._fold(ctx)

    def drain(self):
        while self.inflight:           # final drain, FIFO
            ctx = self.inflight.popleft()
            # all but the last in-flight batch had later edge work
            # dispatched behind them
            ctx.overlapped = bool(self.inflight)
            self._fold(ctx)


def _drive_pipeline(stream, *, batch_size: int, max_samples: int,
                    overlap: bool, overlap_depth: int,
                    process_batch, finalize) -> int:
    """Offline driver: replay a finite stream through a `_PipelineDriver`.
    Returns the batch count."""
    driver = _PipelineDriver(batch_size=batch_size, overlap=overlap,
                             overlap_depth=overlap_depth,
                             process_batch=process_batch,
                             finalize=finalize)
    for batch in microbatches(stream, batch_size, max_samples):
        driver.push(batch)
    driver.drain()
    return driver.batches


def _resolve_cloud(ctx: _BatchCtx):
    """Resolve ctx's cloud flush: patch cloud predictions into
    ``ctx.batch_preds`` and return (conf_Ls, offload_bytes) per slot.
    Bytes are the flush's own measured payload
    (``PendingFlush.slot_bytes``, recorded at dispatch)."""
    size = len(ctx.arms)
    cloud = ctx.pending.resolve()
    conf_Ls: List[Optional[float]] = [None] * size
    obs = [0] * size
    for s, (c_L, p_L) in cloud.items():
        conf_Ls[s] = c_L
        ctx.batch_preds[s] = p_L
        obs[s] = ctx.pending.slot_bytes[s]
    return conf_Ls, obs


def _serve_result(ctl: SplitEEController, *, n: int, batch_size: int,
                  replicas: int, preds, correct, overlap: bool,
                  overlap_depth: int, batches: int,
                  overlapped: int) -> Dict[str, Any]:
    """Result dict of the sharded runtime (and of the distributed one,
    once ported)."""
    hist = {k: np.asarray(v) for k, v in ctl.history.items()}
    tot = ctl.totals
    out = {
        "n": n,
        "batch_size": batch_size,
        "replicas": replicas,
        "preds": np.asarray(preds),
        # scalar accounting comes from the controller's O(1) aggregates
        # so it survives record_history=False
        "cost_total": float(tot["cost"]),
        "offload_frac": (1.0 - tot["exited"] / tot["served"]
                         if tot["served"] else 0.0),
        "offload_bytes": int(tot["offload_bytes"]),
        "arms": hist["arm"],
        "rewards": hist["reward"],
        "exited": hist["exited"],
        "overlap": {"enabled": overlap, "depth": overlap_depth,
                    "batches": batches, "batches_overlapped": overlapped},
        "state": ctl.snapshot(),
    }
    if correct:
        out["accuracy"] = float(np.mean(correct))
    return out


class _ShardedSession:
    """Incremental driver of the sharded micro-batch schedule.

    Owns the mesh placement, controller, offload queue, and the depth-K
    `_PipelineDriver`; one `push(batch)` runs exactly one round of the
    offline loop, so the one-shot `_serve_stream_sharded` and the
    push-mode `api.Engine` are the same machinery by construction.
    What ``replicas``/``overlap``/``overlap_depth`` mean is in the module
    docstring above.
    """

    def __init__(self, runtime: EdgeCloudRuntime, params, cost: CostModel,
                 *, batch_size: int = 32, replicas: int = 1,
                 mesh: Optional[ServingMesh] = None, overlap: bool = True,
                 overlap_depth: int = 1, side_info: bool = False,
                 beta: float = 1.0, labels_for_accounting: bool = True,
                 record_trace: bool = False, edge_mode: str = "bucketed",
                 controller_kwargs: Optional[Dict[str, Any]] = None,
                 codec: Optional[OffloadCodec] = None):
        from repro_torch.serving.scan_edge import select_edge_phase
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if overlap_depth < 1:
            raise ValueError(
                f"overlap_depth must be >= 1, got {overlap_depth}")
        if mesh is None:
            mesh = make_serving_mesh(replicas, device=runtime.device)
        if "data" not in mesh.axis_names:
            raise ValueError(
                f"mesh needs a 'data' axis, got {mesh.axis_names}")
        if replicas > mesh.shape["data"]:
            raise ValueError(f"replicas={replicas} exceeds data axis "
                             f"size {mesh.shape['data']}")

        self.runtime = runtime
        self.cost = cost
        self.batch_size = batch_size
        self.replicas = replicas
        self.overlap = overlap
        self.overlap_depth = overlap_depth
        self.side_info = side_info
        self.labels_for_accounting = labels_for_accounting
        self.edge_mode = edge_mode
        self._edge_phase = select_edge_phase(edge_mode)

        devices = _data_devices(mesh)
        self.put = _data_put(mesh)
        self.params = _replicate_params(mesh, params, runtime, devices)
        self._replicated = _ReplicatedRuntime(runtime)

        self.ctl = SplitEEController(cost, beta=beta, side_info=side_info,
                                     **(controller_kwargs or {}))
        self.codec = codec
        self.queue = OffloadQueue(self._replicated, self.params,
                                  put=self.put, codec=codec)
        self.correct: List[int] = []
        self.preds: List[int] = []
        self.trace: Optional[Dict[str, list]] = (
            {"conf_path": [], "conf_L": []} if record_trace else None)
        self.n = 0
        self.overlapped = 0
        self._driver = _PipelineDriver(
            batch_size=batch_size, overlap=overlap,
            overlap_depth=overlap_depth,
            process_batch=self._process_batch, finalize=self._finalize)

    def _process_batch(self, batch, start: int) -> _BatchCtx:
        """Select arms, launch the batch's edge calls, dispatch the flush."""
        B = len(batch)
        arms = self.ctl.choose_splits(B)
        tokens = np.stack([np.asarray(s["tokens"]) for s in batch])

        # ---- edge: data-parallel bucket calls, or one masked forward ---
        conf_paths, batch_preds = self._edge_phase(
            self._replicated, self.params, tokens, arms, self.cost,
            self.queue, side_info=self.side_info, put=self.put,
            replicas=self.replicas)

        # ---- cloud: dispatch the flush; resolve now or K batches later -
        pending = self.queue.flush_async(
            min_rows=self.replicas,
            depth=self.overlap_depth if self.overlap else None)
        labels = [int(s["labels"]) if "labels" in s else None
                  for s in batch]
        return _BatchCtx(arms=arms, conf_paths=conf_paths,
                         batch_preds=batch_preds, labels=labels,
                         seq_len=tokens.shape[1], pending=pending,
                         start=start)

    def _finalize(self, ctx: _BatchCtx):
        """Resolve the cloud flush, merge per-replica stats, book results."""
        B = len(ctx.arms)
        conf_Ls, obs = _resolve_cloud(ctx)
        scale = _offload_scale(self.codec, self.runtime, ctx.seq_len)
        # per-replica shard summaries, merged at the batch boundary
        shards = []
        lo = 0
        for size in _shard_sizes(B, self.replicas):
            hi = lo + size
            if size:
                # ctx.start is the batch's global stream position — with
                # overlap the fold runs behind selection, so the
                # controller's own round counter would lag the trace
                shards.append(self.ctl.prepare_shard_update(
                    ctx.arms[lo:hi], ctx.conf_paths[lo:hi],
                    conf_Ls[lo:hi], obs[lo:hi], round=ctx.start,
                    offload_scale=scale))
            lo = hi
        self.ctl.merge_shard_updates(shards)
        self.preds.extend(ctx.batch_preds)
        if self.trace is not None:
            self.trace["conf_path"].extend(ctx.conf_paths)
            self.trace["conf_L"].extend(conf_Ls)
        if self.labels_for_accounting:
            for s in range(B):
                if ctx.labels[s] is not None:
                    self.correct.append(
                        int(ctx.batch_preds[s] == ctx.labels[s]))
        if ctx.overlapped:
            self.overlapped += 1
        self.n += B

    def push(self, batch):
        """Serve one micro-batch (any size >= 1; ragged tails included).
        An empty push is a no-op — a scheduler tick or drain that formed
        nothing must not spend a bandit round."""
        if not batch:
            return
        self._driver.push(batch)

    def drain(self):
        """Resolve and fold every in-flight overlapped cloud flush."""
        self._driver.drain()

    def result(self) -> Dict[str, Any]:
        out = _serve_result(self.ctl, n=self.n, batch_size=self.batch_size,
                            replicas=self.replicas, preds=self.preds,
                            correct=self.correct, overlap=self.overlap,
                            overlap_depth=self.overlap_depth,
                            batches=self._driver.batches,
                            overlapped=self.overlapped)
        if self.trace is not None:
            out["trace"] = self.trace
        return out


def _serve_stream_sharded(runtime: EdgeCloudRuntime, params, stream,
                          cost: CostModel, *, batch_size: int = 32,
                          replicas: int = 1,
                          mesh: Optional[ServingMesh] = None,
                          overlap: bool = True, overlap_depth: int = 1,
                          side_info: bool = False,
                          beta: float = 1.0, max_samples: int = 0,
                          labels_for_accounting: bool = True,
                          record_trace: bool = False,
                          edge_mode: str = "bucketed",
                          controller_kwargs: Optional[Dict[str, Any]] = None,
                          codec: Optional[OffloadCodec] = None,
                          ) -> Dict[str, Any]:
    """Offline driver: replay a finite stream through a sharded session.

    Same contract as `_serve_stream_batched`, plus:

    ``replicas``  data-parallel replica count (must fit the mesh's
                  "data" axis; a 1-D mesh of `replicas` replicas on the
                  runtime's device is built when ``mesh`` is None).
    ``mesh``      explicit `ServingMesh` with a "data" axis.
    ``overlap``   pipeline the offload queue: batch t's cloud flush is
                  resolved only after up to ``overlap_depth`` later
                  batches have dispatched their edge work. Off: cloud
                  resolves at t's own boundary, reproducing the
                  synchronous batched semantics.
    ``overlap_depth``  max in-flight cloud flushes K (>= 1); feedback is
                  delayed by up to (K+1)*B-1 rounds (asserted at every
                  fold).
    """
    sess = _ShardedSession(runtime, params, cost, batch_size=batch_size,
                           replicas=replicas, mesh=mesh, overlap=overlap,
                           overlap_depth=overlap_depth, side_info=side_info,
                           beta=beta,
                           labels_for_accounting=labels_for_accounting,
                           record_trace=record_trace, edge_mode=edge_mode,
                           controller_kwargs=controller_kwargs, codec=codec)
    for batch in microbatches(stream, batch_size, max_samples):
        sess.push(batch)
    sess.drain()
    return sess.result()
