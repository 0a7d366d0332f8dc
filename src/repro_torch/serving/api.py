"""Unified serving API: one declarative config, one facade, one report.

* `ServingConfig` — a frozen, validated, JSON-round-trippable dataclass
  describing *what* to serve. It has every field of the reference's
  config, with the same validation and messages, so a JSON document the
  reference's ``to_json()`` wrote loads here unchanged, and the reverse.
* `serve(runtime, params, stream, cost, config)` — the facade. Resolves
  the cheapest serving path that satisfies the config (`resolved_path`)
  and returns a typed `ServeReport`. The port runs the sequential,
  batched and sharded paths (bucketed, scan or auto edge phase, any
  offload codec; the sharded runtime over R replicas of a ``mesh`` with
  the depth-K offload pipeline, or Megatron-split over a ("data",
  "model") `DeviceMesh`) and the decode runtime
  (``workload="decode"``, serving/decode.py) and the distributed runtime
  (serving/distributed.py: one process of a cluster, its batch slice and
  the host-side exchange; ``exchange``/``init_state``/``stream_offset``
  are its runtime resources, and another path refuses them with the
  reference's error).
* `Engine` — a push-session over the same controller/queue machinery:
  `submit(samples)` / `drain()` / `close()`. A push-session over the same
  samples is bit-identical to the one-shot `serve()` call; with
  ``scheduler="fifo"`` submits go through a `RequestScheduler`.
* `MultiTenantEngine` — several tenants behind one shared scheduler.

The reference's deprecated `serve_stream` / `serve_stream_batched`
wrappers are not carried over: the port has no legacy callers.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.controller import CONTROLLER_MODES
from repro_torch.core.rewards import CostModel, CostTrace
from repro_torch.serving.batched import (_BatchedSession,
                                         _serve_stream_batched)
from repro_torch.serving.decode import (DecodeRuntime, _DecodeSession,
                                        _serve_stream_decode)
from repro_torch.serving.distributed import _serve_stream_distributed
from repro_torch.serving.offload_codec import (QUANT_MODES, OffloadCodec,
                                               codec_from_fields)
from repro_torch.serving.scheduler import (SCHEDULERS, SHED_POLICIES,
                                           RequestScheduler)
from repro_torch.serving.sharded import (_ShardedSession,
                                         _serve_stream_sharded)
from repro_torch.serving.simulator import (EdgeCloudRuntime,
                                           _serve_stream_sequential)

PATHS = ("auto", "sequential", "batched", "sharded", "distributed")
EDGE_MODES = ("bucketed", "scan", "auto")
WORKLOADS = ("classify", "decode")
SPLIT_POLICIES = ("bandit", "final")


def _err(field: str, got, fix: str) -> str:
    """Uniform actionable-message shape for config validation errors."""
    return f"ServingConfig.{field} = {got!r} is invalid: {fix}"


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Declarative description of one serving run.

    ``path`` pins a specific runtime ("sequential" | "batched" |
    "sharded" | "distributed"); the default "auto" resolves to the
    cheapest path that satisfies the rest of the config (see
    `resolved_path`). The fields are the reference's, field for field;
    fields a path does not use are ignored by it (e.g. `overlap_depth`
    on the batched path).

    Instances are frozen, validated at construction, and JSON
    round-trippable (`to_json` / `from_json`) — a config file is a
    complete, reproducible description of the serving side of a run.
    """

    # ---- path selection ------------------------------------------------
    path: str = "auto"
    # ---- workload ------------------------------------------------------
    workload: str = "classify"        # "decode" = autoregressive generation
    max_new_tokens: int = 0           # decode: tokens generated per sequence
    split_policy: str = "bandit"      # decode: "final" forces full depth
    tenant: Optional[str] = None      # label for MultiTenantEngine routing
    # ---- micro-batching / policy (all paths) ---------------------------
    batch_size: int = 1
    edge_mode: str = "bucketed"       # "scan" = one masked-scan program
    side_info: bool = False           # SplitEE-S: read all exits <= depth
    beta: float = 1.0                 # UCB exploration coefficient
    max_samples: int = 0              # 0 = serve the stream to exhaustion
    labels_for_accounting: bool = True
    # ---- data parallelism (sharded / distributed) ----------------------
    replicas: int = 1                 # per-process data-parallel replicas
    mesh: bool = False                # force the sharded (mesh) runtime
    # ---- async offload pipeline (sharded / distributed) ----------------
    overlap: bool = True
    overlap_depth: int = 1            # max in-flight cloud flushes K
    # ---- multi-process serving -----------------------------------------
    distributed: bool = False
    fault_tolerant: bool = False
    heartbeat_timeout: float = 5.0
    heartbeat_interval: float = 0.25
    # ---- request scheduling (Engine sessions; see serving/scheduler.py)
    scheduler: str = "none"           # "fifo" = continuous-batching scheduler
    max_queue: int = 0                # admission cap; 0 = unbounded queue
    batch_deadline_ms: float = 0.0    # close partial batches after this wait
    shed_policy: str = "reject"       # queue-full policy: reject | drop_oldest
    # ---- quantized offload (all paths) ---------------------------------
    offload_quant: str = "none"       # | "int8" | "int4" per-channel affine
    offload_sparsity: float = 0.0     # fraction of entries dropped (top-|x|)
    offload_error_feedback: bool = False  # decode: fold dropped mass forward
    # ---- non-stationary controller (all paths) -------------------------
    controller_mode: str = "stationary"  # | "sliding_window" | "discounted"
    window: int = 0                   # sliding-window size in batches; 0 = inf
    discount: float = 1.0             # discounted-mode decay factor gamma
    cost_trace: Optional[Dict[str, Any]] = None  # CostTrace.to_dict() payload
    # ---- diagnostics ---------------------------------------------------
    record_trace: bool = False        # per-sample confidences (batched/sharded)
    record_states: bool = False       # per-batch controller snapshots (distributed)
    record_history: bool = True       # per-sample controller history lists

    def __post_init__(self):
        if self.path not in PATHS:
            raise ValueError(_err("path", self.path,
                                  f"choose one of {PATHS}"))
        if self.batch_size < 1:
            raise ValueError(_err(
                "batch_size", self.batch_size,
                "micro-batches need at least 1 sample; use batch_size=1 "
                "for the per-sample sequential path"))
        if self.replicas < 1:
            raise ValueError(_err(
                "replicas", self.replicas,
                "the data-parallel replica count must be >= 1; use "
                "replicas=1 for a single-device run"))
        if self.overlap_depth < 1:
            raise ValueError(_err(
                "overlap_depth", self.overlap_depth,
                "the offload pipeline keeps >= 1 cloud flush in flight "
                "(1 = double buffering); to disable overlap entirely set "
                "overlap=False instead"))
        if self.beta <= 0:
            raise ValueError(_err(
                "beta", self.beta,
                "the UCB exploration coefficient must be > 0 "
                "(the paper uses 1.0)"))
        if self.max_samples < 0:
            raise ValueError(_err(
                "max_samples", self.max_samples,
                "use 0 to serve the stream to exhaustion, or a positive "
                "sample cap"))
        if self.heartbeat_timeout <= 0:
            raise ValueError(_err(
                "heartbeat_timeout", self.heartbeat_timeout,
                "failure detection needs a positive staleness bound "
                "(seconds; default 5.0)"))
        if self.heartbeat_interval <= 0:
            raise ValueError(_err(
                "heartbeat_interval", self.heartbeat_interval,
                "heartbeats must be stamped at a positive interval "
                "(seconds; default 0.25)"))
        if self.heartbeat_interval >= self.heartbeat_timeout:
            raise ValueError(_err(
                "heartbeat_interval", self.heartbeat_interval,
                f"must be smaller than heartbeat_timeout "
                f"({self.heartbeat_timeout}) or every host looks dead; "
                f"keep timeout >= 10x interval"))
        # path = "distributed" implies the distributed flag (normalized so
        # JSON round-trips are stable)
        if self.path == "distributed" and not self.distributed:
            object.__setattr__(self, "distributed", True)
        if self.distributed and self.path in ("sequential", "batched",
                                              "sharded"):
            raise ValueError(_err(
                "distributed", True,
                f"conflicts with path={self.path!r}; use path='auto' or "
                f"path='distributed'"))
        if self.scheduler not in SCHEDULERS:
            raise ValueError(_err("scheduler", self.scheduler,
                                  f"choose one of {SCHEDULERS}"))
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(_err("shed_policy", self.shed_policy,
                                  f"choose one of {SHED_POLICIES}"))
        if self.max_queue < 0:
            raise ValueError(_err(
                "max_queue", self.max_queue,
                "use 0 for an unbounded admission queue, or a positive "
                "cap to shed under overload"))
        if self.batch_deadline_ms < 0:
            raise ValueError(_err(
                "batch_deadline_ms", self.batch_deadline_ms,
                "use 0 to close micro-batches on fill only, or a "
                "positive wait bound (milliseconds)"))
        if self.scheduler == "none" and (self.max_queue
                                         or self.batch_deadline_ms):
            field = "max_queue" if self.max_queue else "batch_deadline_ms"
            raise ValueError(_err(
                field, getattr(self, field),
                "admission control and deadline batch closing are "
                "request-scheduler features; set scheduler='fifo'"))
        if self.scheduler != "none" and self.distributed:
            raise ValueError(_err(
                "scheduler", self.scheduler,
                "the request scheduler drives a single-process Engine "
                "session; distributed clusters must consume a shared "
                "offline stream (set distributed=False)"))
        if self.edge_mode not in EDGE_MODES:
            raise ValueError(_err(
                "edge_mode", self.edge_mode,
                f"choose one of {EDGE_MODES} ('bucketed' = one pow2 "
                f"launch per distinct split depth, 'scan' = one "
                f"masked scan-over-layers program per batch shape, "
                f"'auto' = pick per batch from the observed depth mix)"))
        if self.edge_mode in ("scan", "auto") and self.path == "sequential":
            raise ValueError(_err(
                "edge_mode", self.edge_mode,
                "the sequential path has no micro-batch edge phase to "
                "swap; use path='batched' (or leave path='auto', which "
                "resolves scan/auto configs to the batched runtime)"))
        if self.edge_mode in ("scan", "auto") and self.distributed:
            raise ValueError(_err(
                "edge_mode", self.edge_mode,
                "the distributed runtime keeps the bucketed edge phase; "
                "use the batched/sharded paths for scan/auto mode"))
        if self.offload_quant not in QUANT_MODES:
            raise ValueError(_err(
                "offload_quant", self.offload_quant,
                f"choose one of {QUANT_MODES} (per-channel affine "
                f"quantization of the offloaded activation; 'none' ships "
                f"the full-dtype tensor)"))
        if not 0.0 <= self.offload_sparsity < 1.0:
            raise ValueError(_err(
                "offload_sparsity", self.offload_sparsity,
                "the fraction of activation entries dropped before "
                "offload must be in [0, 1); 0.0 ships every entry"))
        if self.controller_mode not in CONTROLLER_MODES:
            raise ValueError(_err(
                "controller_mode", self.controller_mode,
                f"choose one of {CONTROLLER_MODES} ('sliding_window' "
                f"forgets beyond the last `window` batches, 'discounted' "
                f"decays pull counts by `discount` per sample)"))
        if self.window < 0:
            raise ValueError(_err(
                "window", self.window,
                "the sliding window is counted in micro-batches and must "
                "be >= 0 (0 = unbounded, bit-identical to stationary)"))
        if self.window and self.controller_mode != "sliding_window":
            raise ValueError(_err(
                "window", self.window,
                f"a finite window needs "
                f"controller_mode='sliding_window', got "
                f"{self.controller_mode!r}"))
        if not 0.0 < self.discount <= 1.0:
            raise ValueError(_err(
                "discount", self.discount,
                "the per-sample decay factor gamma must be in (0, 1] "
                "(1.0 = no forgetting, bit-identical to stationary)"))
        if self.discount != 1.0 and self.controller_mode != "discounted":
            raise ValueError(_err(
                "discount", self.discount,
                f"a decay factor != 1.0 needs "
                f"controller_mode='discounted', got "
                f"{self.controller_mode!r}"))
        if self.cost_trace is not None:
            try:
                CostTrace.from_dict(self.cost_trace)
            except (ValueError, TypeError) as e:
                raise ValueError(_err(
                    "cost_trace", self.cost_trace,
                    f"must be a CostTrace.to_dict() payload: {e}")) from e
        if self.fault_tolerant and not self.distributed:
            raise ValueError(_err(
                "fault_tolerant", True,
                "fault tolerance is a property of the multi-process "
                "runtime; set distributed=True (or path='distributed')"))
        if self.record_states and not self.distributed:
            raise ValueError(_err(
                "record_states", True,
                "per-batch controller snapshots are recorded by the "
                "distributed runtime only; set distributed=True"))
        if self.record_trace and self.path in ("sequential", "distributed"):
            raise ValueError(_err(
                "record_trace", True,
                f"the per-sample confidence trace exists on the batched "
                f"and sharded paths only, not path={self.path!r}"))
        if self.record_trace and self.distributed:
            raise ValueError(_err(
                "record_trace", True,
                "the distributed runtime records controller snapshots "
                "(record_states), not per-sample traces"))
        if self.mesh and self.path in ("sequential", "batched"):
            raise ValueError(_err(
                "mesh", True,
                f"conflicts with path={self.path!r}; the mesh runtime is "
                f"path='sharded' (or leave path='auto')"))
        if self.replicas > 1 and self.path in ("sequential", "batched"):
            raise ValueError(_err(
                "replicas", self.replicas,
                f"path={self.path!r} runs on one replica; use "
                f"path='sharded'/'distributed' (or path='auto')"))
        if self.batch_size > 1 and self.path == "sequential":
            raise ValueError(_err(
                "batch_size", self.batch_size,
                "the sequential path serves one sample per round; use "
                "path='batched' (or path='auto')"))
        if self.workload not in WORKLOADS:
            raise ValueError(_err("workload", self.workload,
                                  f"choose one of {WORKLOADS}"))
        if self.split_policy not in SPLIT_POLICIES:
            raise ValueError(_err(
                "split_policy", self.split_policy,
                f"choose one of {SPLIT_POLICIES} ('bandit' = SplitEE's "
                f"UCB splitting layer, 'final' = full-depth decode, the "
                f"final-layer-always baseline)"))
        if self.max_new_tokens < 0:
            raise ValueError(_err(
                "max_new_tokens", self.max_new_tokens,
                "the decode budget must be >= 1 (decode workloads) or 0 "
                "(classify workloads)"))
        if self.workload == "decode":
            if self.max_new_tokens < 1:
                raise ValueError(_err(
                    "max_new_tokens", self.max_new_tokens,
                    "decode workloads generate at least one token per "
                    "sequence; set max_new_tokens >= 1"))
            if self.path != "auto":
                raise ValueError(_err(
                    "path", self.path,
                    "decode workloads run their own runtime "
                    "(serving/decode.py), not the classifier path ladder; "
                    "leave path='auto'"))
            for field, why in (
                    ("distributed", "multi-process serving"),
                    ("fault_tolerant", "fault tolerance"),
                    ("mesh", "the sharded mesh runtime"),
                    ("side_info", "SplitEE-S side information"),
                    ("record_trace", "the per-sample confidence trace"),
                    ("record_states", "per-batch controller snapshots")):
                if getattr(self, field):
                    raise ValueError(_err(
                        field, True,
                        f"{why} is a classifier-path feature; the decode "
                        f"runtime does not support it yet"))
            if self.replicas > 1:
                raise ValueError(_err(
                    "replicas", self.replicas,
                    "the decode runtime is single-replica; data "
                    "parallelism for decode is future work"))
            if self.edge_mode != "bucketed":
                raise ValueError(_err(
                    "edge_mode", self.edge_mode,
                    "the decode runtime always runs one masked program "
                    "per step (its own edge phase); leave the default "
                    "edge_mode='bucketed'"))
        else:
            if self.max_new_tokens:
                raise ValueError(_err(
                    "max_new_tokens", self.max_new_tokens,
                    "token budgets apply to decode workloads; set "
                    "workload='decode'"))
            if self.split_policy != "bandit":
                raise ValueError(_err(
                    "split_policy", self.split_policy,
                    "the forced-final baseline exists for decode "
                    "workloads; set workload='decode'"))
            if self.offload_error_feedback:
                raise ValueError(_err(
                    "offload_error_feedback", True,
                    "error feedback accumulates residuals across one "
                    "sequence's successive offloads — a decode-workload "
                    "notion; set workload='decode'"))
        if self.offload_error_feedback and self.offload_quant == "none" \
                and self.offload_sparsity == 0.0:
            raise ValueError(_err(
                "offload_error_feedback", True,
                "the identity codec drops nothing, so there is no "
                "residual to feed back; set offload_quant and/or "
                "offload_sparsity"))

    def resolved_path(self) -> str:
        """The concrete runtime this config selects.

        "auto" picks the cheapest path whose features cover the config:
        multi-process wants the distributed runtime, replicas/mesh the
        sharded one, micro-batches (or a trace) the batched one, and a
        plain B=1 run the per-sample sequential loop. The bit-identity
        ladder (sequential = batched@B=1 = sharded@R=1,sync =
        distributed@H=1) means this selection never changes the policy —
        only how much machinery runs.
        """
        if self.workload == "decode":
            return "decode"
        if self.path != "auto":
            return self.path
        if self.distributed or self.fault_tolerant:
            return "distributed"
        if self.replicas > 1 or self.mesh:
            return "sharded"
        if (self.batch_size > 1 or self.record_trace
                or self.edge_mode in ("scan", "auto")):
            return "batched"
        return "sequential"

    # ------------------------------------------------------------- JSON
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2,
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ServingConfig":
        raw = json.loads(text)
        if not isinstance(raw, dict):
            raise ValueError(
                f"a ServingConfig JSON document must be an object, got "
                f"{type(raw).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - fields)
        if unknown:
            raise ValueError(
                f"unknown ServingConfig field(s) {unknown}; valid fields "
                f"are {sorted(fields)}")
        return cls(**raw)


@dataclasses.dataclass
class ServeReport:
    """Typed result of one serving run (or `Engine` session).

    Replaces the legacy entrypoints' ad-hoc dicts. For migration the
    report is also dict-like (`report["arms"]`, `report.get("accuracy")`,
    `"trace" in report`) with exactly the legacy keys plus the new typed
    extras; optional fields that are absent behave like missing keys.
    """

    n: int
    preds: np.ndarray
    cost_total: float
    offload_frac: float
    offload_bytes: int
    arms: np.ndarray
    rewards: np.ndarray
    exited: Optional[np.ndarray] = None
    exits_per_layer: Optional[np.ndarray] = None   # exit counts, arm 0..L-1
    accuracy: Optional[float] = None
    batch_size: Optional[int] = None
    replicas: Optional[int] = None
    path: Optional[str] = None                     # runtime that served
    wall_s: Optional[float] = None
    samples_per_sec: Optional[float] = None
    overlap: Optional[Dict[str, Any]] = None       # offload pipeline stats
    state: Optional[Dict[str, Any]] = None         # final controller (q, n, t)
    trace: Optional[Dict[str, list]] = None        # per-sample confidences
    distributed: Optional[Dict[str, Any]] = None   # cluster section
    states: Optional[List[Dict[str, Any]]] = None  # per-batch snapshots
    scheduler: Optional[Dict[str, Any]] = None     # request-scheduler stats
    decode: Optional[Dict[str, Any]] = None        # decode-workload section
    tenant: Optional[str] = None                   # MultiTenantEngine label

    @classmethod
    def from_raw(cls, raw: Dict[str, Any], *, path: str, num_layers: int,
                 wall_s: Optional[float] = None) -> "ServeReport":
        """Wrap a serving runtime's raw result dict."""
        arms = np.asarray(raw["arms"])
        if arms.size == 0:        # empty history: float64 by default,
            arms = arms.astype(np.int64)   # but arms index bincount
        exited = raw.get("exited")
        exits_per_layer = None
        if exited is not None:
            exited = np.asarray(exited).astype(bool)
            exits_per_layer = np.bincount(arms[exited],
                                          minlength=num_layers)
        wall = float(wall_s) if wall_s is not None else None
        return cls(
            n=int(raw["n"]),
            preds=np.asarray(raw["preds"]),
            cost_total=float(raw["cost_total"]),
            offload_frac=float(raw["offload_frac"]),
            offload_bytes=int(raw["offload_bytes"]),
            arms=arms,
            rewards=np.asarray(raw["rewards"]),
            exited=exited,
            exits_per_layer=exits_per_layer,
            accuracy=raw.get("accuracy"),
            batch_size=raw.get("batch_size"),
            replicas=raw.get("replicas"),
            path=path,
            wall_s=wall,
            samples_per_sec=(round(int(raw["n"]) / wall, 2)
                             if wall else None),
            overlap=raw.get("overlap"),
            state=raw.get("state"),
            trace=raw.get("trace"),
            distributed=raw.get("distributed"),
            states=raw.get("states"),
            scheduler=raw.get("scheduler"),
            decode=raw.get("decode"),
            tenant=raw.get("tenant"),
        )

    def to_dict(self) -> Dict[str, Any]:
        """Legacy-shaped dict: every non-None field under its old key."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                out[f.name] = v
        return out

    # dict-like migration surface ---------------------------------------
    def __getitem__(self, key: str):
        d = self.to_dict()
        if key not in d:
            raise KeyError(key)
        return d[key]

    def __contains__(self, key: str) -> bool:
        return key in self.to_dict()

    def get(self, key: str, default=None):
        return self.to_dict().get(key, default)

    def keys(self):
        return self.to_dict().keys()

    def values(self):
        return self.to_dict().values()

    def items(self):
        return self.to_dict().items()

    def __iter__(self):
        return iter(self.to_dict())

    def __len__(self) -> int:
        return len(self.to_dict())


# ----------------------------------------------------------------- facade

def _codec_from_config(config: ServingConfig) -> Optional[OffloadCodec]:
    """The offload codec a config implies, or None for the identity
    config (quant='none', sparsity=0.0) — so codec-free runs keep
    today's exact byte-for-byte path."""
    return codec_from_fields(config.offload_quant, config.offload_sparsity,
                             config.offload_error_feedback)


def _controller_kwargs(config: ServingConfig) -> Optional[Dict[str, Any]]:
    """Controller-construction kwargs a config implies, or None when the
    config asks for the default stationary controller (so legacy paths
    construct it exactly as before)."""
    if (config.controller_mode == "stationary"
            and config.cost_trace is None and config.record_history):
        return None
    return dict(
        mode=config.controller_mode, window=config.window,
        discount=config.discount,
        cost_trace=(CostTrace.from_dict(config.cost_trace)
                    if config.cost_trace is not None else None),
        record_history=config.record_history)


def serve(runtime: EdgeCloudRuntime, params, stream, cost: CostModel,
          config: Optional[ServingConfig] = None, *,
          mesh=None, exchange=None, init_state=None,
          stream_offset: int = 0, **overrides) -> ServeReport:
    """Serve a sample stream under a `ServingConfig`.

    Resolves the config to a runtime (see `ServingConfig.resolved_path`)
    and returns a `ServeReport`. ``samples_per_sec`` is wall time around
    the driver; every micro-batch reads its decisions back (the sharded
    path reads its last flushes back at its drain), so the device work is
    inside it.

    Keyword-only arguments carry *runtime resources* that cannot live in
    a JSON config:

    ``mesh``           explicit `launch.mesh.ServingMesh` with a "data"
                       axis, or a ``torch.distributed`` `DeviceMesh` with
                       "data" and "model" axes (model parallelism: every
                       rank of its process group makes the same call;
                       `launch.mesh.make_model_serving_mesh`), for the
                       sharded / distributed paths; without one they
                       build a 1-D mesh of ``config.replicas`` replicas on
                       the runtime's device. A mesh on another path
                       raises the reference's ``ValueError``.
    ``exchange``       cross-host transport override (distributed path).
    ``init_state``     controller snapshot to restore before serving —
                       the distributed rejoin path.
    ``stream_offset``  samples the caller already consumed (rejoin).

    ``exchange``/``init_state``/``stream_offset`` on another path raise
    the reference's ``ValueError``. A `DecodeRuntime` needs a decode
    config (``workload="decode"``), and a decode config needs a
    `DecodeRuntime`.

    Any extra keyword arguments are `ServingConfig` field overrides:
    ``serve(rt, p, s, c, batch_size=32)`` replaces the field on the
    (default) config.
    """
    if config is None:
        config = ServingConfig()
    if overrides:
        config = dataclasses.replace(config, **overrides)
    path = config.resolved_path()
    if isinstance(runtime, DecodeRuntime) and path != "decode":
        raise ValueError(
            f"runtime is a DecodeRuntime but the config resolves to "
            f"path={path!r}; set ServingConfig(workload='decode', "
            f"max_new_tokens=...)")
    if mesh is not None and path not in ("sharded", "distributed"):
        raise ValueError(
            f"an explicit mesh applies to the sharded/distributed paths; "
            f"this config resolves to {path!r} (set replicas/mesh/"
            f"distributed on the config)")
    if (exchange is not None or init_state is not None or stream_offset) \
            and path != "distributed":
        raise ValueError(
            f"exchange/init_state/stream_offset belong to the "
            f"distributed path; this config resolves to {path!r}")
    if config.scheduler != "none":
        # the request scheduler lives behind the Engine session; replay
        # the offline stream through one (over a steady trace with no
        # deadlines it closes only full batches: the unscheduled schedule)
        eng = Engine(runtime, params, cost, config, mesh=mesh)
        for sample in itertools.islice(iter(stream),
                                       config.max_samples or None):
            eng.submit(sample)
        return eng.close()
    if path == "decode":
        t0 = time.perf_counter()
        raw = _serve_stream_decode(
            runtime, params, stream, cost,
            batch_size=config.batch_size,
            max_new_tokens=config.max_new_tokens,
            split_policy=config.split_policy, beta=config.beta,
            max_samples=config.max_samples,
            controller_kwargs=_controller_kwargs(config),
            codec=_codec_from_config(config))
        return ServeReport.from_raw(
            raw, path=path, num_layers=cost.num_layers,
            wall_s=time.perf_counter() - t0)
    common = dict(side_info=config.side_info, beta=config.beta,
                  max_samples=config.max_samples,
                  labels_for_accounting=config.labels_for_accounting,
                  controller_kwargs=_controller_kwargs(config),
                  codec=_codec_from_config(config))
    t0 = time.perf_counter()
    if path == "sequential":
        raw = _serve_stream_sequential(runtime, params, stream, cost,
                                       **common)
    elif path == "batched":
        raw = _serve_stream_batched(runtime, params, stream, cost,
                                    batch_size=config.batch_size,
                                    record_trace=config.record_trace,
                                    edge_mode=config.edge_mode,
                                    **common)
    elif path == "sharded":
        raw = _serve_stream_sharded(runtime, params, stream, cost,
                                    batch_size=config.batch_size,
                                    replicas=config.replicas, mesh=mesh,
                                    overlap=config.overlap,
                                    overlap_depth=config.overlap_depth,
                                    record_trace=config.record_trace,
                                    edge_mode=config.edge_mode,
                                    **common)
    else:
        raw = _serve_stream_distributed(
            runtime, params, stream, cost,
            batch_size=config.batch_size, replicas=config.replicas,
            mesh=mesh, overlap=config.overlap,
            overlap_depth=config.overlap_depth, exchange=exchange,
            fault_tolerant=config.fault_tolerant,
            heartbeat_timeout=config.heartbeat_timeout,
            heartbeat_interval=config.heartbeat_interval,
            init_state=init_state, stream_offset=stream_offset,
            record_states=config.record_states, **common)
    wall = time.perf_counter() - t0
    return ServeReport.from_raw(raw, path=path,
                                num_layers=cost.num_layers, wall_s=wall)


# ----------------------------------------------------------------- engine

def _build_session(runtime, params, cost: CostModel, config: ServingConfig,
                   *, mesh=None):
    """Construct the push-session a config selects (shared by `Engine`
    and `MultiTenantEngine`). Returns (session, path_label)."""
    c = config
    path = c.resolved_path()
    if path == "distributed":
        raise ValueError(
            "Engine does not drive the distributed runtime: every "
            "host must consume the same logical stream, which a "
            "single-process push-session cannot guarantee; call "
            "serve() with the distributed ServingConfig on each host")
    ctl_kw = _controller_kwargs(c)
    codec = _codec_from_config(c)
    if path == "decode":
        if mesh is not None:
            raise ValueError(
                "an explicit mesh applies to the sharded path; this "
                "config resolves to 'decode'")
        sess = _DecodeSession(
            runtime, params, cost, batch_size=c.batch_size,
            max_new_tokens=c.max_new_tokens, split_policy=c.split_policy,
            beta=c.beta, controller_kwargs=ctl_kw, codec=codec)
    elif path == "sharded":
        sess = _ShardedSession(
            runtime, params, cost, batch_size=c.batch_size,
            replicas=c.replicas, mesh=mesh, overlap=c.overlap,
            overlap_depth=c.overlap_depth, side_info=c.side_info,
            beta=c.beta, labels_for_accounting=c.labels_for_accounting,
            record_trace=c.record_trace, edge_mode=c.edge_mode,
            controller_kwargs=ctl_kw, codec=codec)
    else:
        if mesh is not None:
            raise ValueError(
                f"an explicit mesh applies to the sharded path; this "
                f"config resolves to {path!r}")
        if isinstance(runtime, DecodeRuntime):
            raise ValueError(
                f"runtime is a DecodeRuntime but the config resolves to "
                f"path={path!r}; set ServingConfig(workload='decode', "
                f"max_new_tokens=...)")
        # sequential configs ride the batched machinery at B=1, which
        # makes the same decisions
        sess = _BatchedSession(
            runtime, params, cost, batch_size=c.batch_size,
            side_info=c.side_info, beta=c.beta,
            labels_for_accounting=c.labels_for_accounting,
            record_trace=c.record_trace, edge_mode=c.edge_mode,
            controller_kwargs=ctl_kw, codec=codec)
    return sess, path


class Engine:
    """Push-session serving: request-level traffic over the same
    controller/queue machinery as the one-shot `serve()` facade.

    Where `serve()` replays a finite offline stream, an `Engine` accepts
    samples as they arrive — the millions-of-users shape:

        eng = Engine(runtime, params, cost, ServingConfig(batch_size=32))
        eng.submit(request_samples)     # any number, any chunking
        report = eng.drain()            # serve everything submitted so far
        final = eng.close()

    Internally this is a thin incremental driver: submitted samples are
    buffered and pushed through the batched (`_BatchedSession`) or
    sharded (`_ShardedSession`) micro-batch schedule as soon as a full
    micro-batch accumulates; `drain()` serves the ragged tail and
    resolves any in-flight overlapped cloud flushes. Because the pushes
    reproduce exactly the batch sequence `microbatches()` would have
    produced, a session that submits the same samples (with `drain`
    called once, at the end) is **bit-identical** to the one-shot
    `serve()` call. Sequential configs are served through the batched
    machinery at ``B=1``; decode configs through `_DecodeSession` (a push
    prefills and generates one micro-batch). Distributed configs are
    rejected with the reference's ``ValueError``: every host of a cluster
    must consume the same logical stream, which push traffic into one
    process cannot guarantee.

    With ``config.scheduler="fifo"`` submits are routed through a
    `RequestScheduler` (serving/scheduler.py) instead of the plain
    accumulate-and-push buffer: requests carry priorities and shed
    deadlines (``submit(samples, priority=, deadline_ms=)``), a bounded
    queue sheds under overload (``max_queue`` / ``shed_policy``), and
    partial micro-batches close once the oldest request has waited
    ``batch_deadline_ms`` — driven by `tick()`, which time-based hosts
    call between arrivals. The report gains a ``scheduler`` section
    (p50/p99 latency, shed counts by reason, batch fill). ``clock``
    injects a monotonic time source for the scheduler. ``mesh`` is the
    sharded session's explicit `ServingMesh` or `DeviceMesh` (as in
    `serve`; over a `DeviceMesh` every rank runs the same session and
    submits the same samples).
    """

    def __init__(self, runtime: EdgeCloudRuntime, params, cost: CostModel,
                 config: Optional[ServingConfig] = None, *, mesh=None,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config if config is not None else ServingConfig()
        self.cost = cost
        c = self.config
        self._sess, self._path = _build_session(runtime, params, cost, c,
                                                mesh=mesh)
        self._clock = clock if clock is not None else time.monotonic
        self._sched: Optional[RequestScheduler] = None
        if c.scheduler != "none":
            self._sched = RequestScheduler(
                batch_size=c.batch_size, max_queue=c.max_queue,
                batch_deadline_ms=c.batch_deadline_ms,
                shed_policy=c.shed_policy, clock=self._clock)
        self._buf: List[Dict[str, Any]] = []
        self._offered = 0      # samples consumed from submit() arguments
        self._accepted = 0     # samples admitted toward the cap
        self._dropped = 0      # samples rejected by the cap
        self._closed = False
        self._t0 = time.perf_counter()
        self._final: Optional[ServeReport] = None

    # ------------------------------------------------------------- state
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def pending(self) -> int:
        """Samples submitted but not yet pushed through a micro-batch."""
        if self._sched is not None:
            return self._sched.pending
        return len(self._buf)

    @property
    def submitted(self) -> int:
        """Every sample this session consumed from `submit` arguments —
        the conservation total: ``submitted == report.n + pending +
        shed + dropped`` at all times."""
        return self._offered

    @property
    def dropped(self) -> int:
        """Samples rejected because the config's ``max_samples`` cap was
        already reached when they were submitted."""
        return self._dropped

    @property
    def shed(self) -> int:
        """Requests shed by the scheduler (queue-full rejections,
        drop_oldest evictions, expired shed deadlines); 0 without a
        scheduler config."""
        return self._sched.shed if self._sched is not None else 0

    @property
    def scheduler(self) -> Optional[RequestScheduler]:
        """The session's `RequestScheduler` (None without one) — for
        event-loop hosts that schedule `tick()` via ``next_fire()``."""
        return self._sched

    # --------------------------------------------------------- lifecycle
    def submit(self, samples, *, priority: int = 0,
               deadline_ms: Optional[float] = None) -> int:
        """Push samples into the session; returns how many were accepted.

        ``samples`` is one sample dict or an iterable of them. Full
        micro-batches are served immediately; a ragged remainder waits
        for more traffic (or `drain`). Once the config's ``max_samples``
        cap is reached, submit stops consuming a lazy iterable (so an
        unbounded source returns promptly, mirroring how the one-shot
        facade stops pulling its stream at the cap); every rejected
        sample of a sized sequence — and, for a lazy iterable, the one
        sample consumed to detect the cap — is counted in
        `Engine.dropped`.

        ``priority`` and ``deadline_ms`` are per-request scheduling
        metadata (higher priority serves sooner; ``deadline_ms`` is the
        shed deadline relative to arrival) and require a scheduler
        config; scheduler admission may shed instead of accepting (see
        `Engine.shed`).
        """
        if self._closed:
            raise RuntimeError("Engine is closed; create a new session")
        if self._sched is None and (priority != 0
                                    or deadline_ms is not None):
            raise ValueError(
                "priority/deadline_ms are request-scheduler metadata; "
                "set ServingConfig(scheduler='fifo')")
        if isinstance(samples, dict):
            samples = [samples]
        sized = isinstance(samples, (list, tuple))
        cap = self.config.max_samples
        accepted = 0
        for i, s in enumerate(samples):
            if cap and self._accepted >= cap:
                rejected = len(samples) - i if sized else 1
                self._offered += rejected
                self._dropped += rejected
                break
            self._offered += 1
            if self._sched is not None:
                if self._sched.offer(s, priority=priority,
                                     deadline_ms=deadline_ms):
                    self._accepted += 1
                    accepted += 1
            else:
                self._buf.append(s)
                self._accepted += 1
                accepted += 1
                if len(self._buf) >= self.config.batch_size:
                    self._sess.push(self._buf)
                    self._buf = []
        if self._sched is not None:
            self._pump()
        return accepted

    def tick(self) -> int:
        """Let the scheduler act on the passage of time: shed expired
        requests and close any partial micro-batch whose oldest request
        has waited ``batch_deadline_ms``. Returns the number of samples
        served by this tick (0 without a scheduler config — time never
        changes the plain accumulate-and-push schedule)."""
        if self._closed:
            raise RuntimeError("Engine is closed; create a new session")
        if self._sched is None:
            return 0
        return self._pump()

    def _pump(self) -> int:
        served = 0
        for reqs in self._sched.poll():
            self._sess.push([r.sample for r in reqs])
            self._sched.complete(reqs)
            served += len(reqs)
        return served

    def drain(self) -> ServeReport:
        """Serve everything submitted so far (including a ragged tail),
        resolve all in-flight cloud flushes, and report. With a
        scheduler, expired requests are shed — never served — and the
        rest goes out in priority order."""
        if self._closed:
            raise RuntimeError("Engine is closed; create a new session")
        if self._sched is not None:
            for reqs in self._sched.flush():
                self._sess.push([r.sample for r in reqs])
                self._sched.complete(reqs)
        elif self._buf:
            self._sess.push(self._buf)
            self._buf = []
        self._sess.drain()
        return self._report()

    def close(self) -> ServeReport:
        """Drain and retire the session; further submits raise.
        Idempotent — repeated closes return the final report."""
        if self._closed:
            return self._final
        self._final = self.drain()
        self._closed = True
        return self._final

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        return False

    def _report(self) -> ServeReport:
        raw = self._sess.result()
        if self._sched is not None:
            # engine-level cap drops ride along so the section alone
            # closes the conservation ledger
            raw["scheduler"] = {**self._sched.snapshot(),
                                "dropped": self._dropped}
        return ServeReport.from_raw(
            raw, path=self._path,
            num_layers=self.cost.num_layers,
            wall_s=time.perf_counter() - self._t0)


# ------------------------------------------------------- multi-tenant

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Everything one tenant brings to a shared engine: its model runtime
    (classifier `EdgeCloudRuntime` or `DecodeRuntime`; families can be
    mixed freely across tenants), parameters, cost model, and the
    per-tenant `ServingConfig` describing its session (batch size, policy
    knobs, workload). Scheduler fields stay on the shared engine — a
    tenant config asking for its own scheduler is rejected. ``mesh``: the
    tenant's sharded session's explicit mesh, as `Engine`'s (the port's
    addition; the reference's tenants take none)."""
    runtime: Any
    params: Any
    cost: CostModel
    config: ServingConfig
    mesh: Any = None


class MultiTenantEngine:
    """One engine, many tenants: mixed model families behind a single
    shared `RequestScheduler` with per-tenant fairness and quotas.

    Each tenant gets its own session (its own controller, queue, caches —
    different tenants usually run different models, so batches NEVER mix
    tenants); the shared scheduler owns admission and batch formation:
    per-tenant batch sizes (each tenant's ``config.batch_size``),
    round-robin fairness across tenants with ready batches
    (least-recently-served first), per-tenant queue quotas
    (``tenant_quota`` — admission sheds with reason "tenant_quota" beyond
    a tenant's cap, so one tenant's burst cannot crowd out the rest), and
    a shared ``batch_deadline_ms`` for partial-batch closing.

    Because the scheduler only *orders* whole per-tenant batches and each
    session is private, a tenant's report is identical to the same stream
    served alone through its own `Engine`. `close()` returns ``{tenant:
    ServeReport}``, each stamped with the tenant label and the scheduler's
    per-tenant conservation ledger (submitted == served + shed + pending).
    """

    def __init__(self, tenants: Dict[str, TenantSpec], *,
                 max_queue: int = 0, batch_deadline_ms: float = 0.0,
                 shed_policy: str = "reject",
                 tenant_quota: Optional[Dict[str, int]] = None,
                 clock: Optional[Callable[[], float]] = None):
        if not tenants:
            raise ValueError("MultiTenantEngine needs at least one tenant")
        for name, spec in tenants.items():
            c = spec.config
            if c.scheduler != "none" or c.max_queue or c.batch_deadline_ms:
                raise ValueError(
                    f"tenant {name!r}: scheduler fields belong to the "
                    f"shared MultiTenantEngine (max_queue / "
                    f"batch_deadline_ms / tenant_quota constructor args); "
                    f"set scheduler='none' on the tenant config")
            if c.tenant is not None and c.tenant != name:
                raise ValueError(
                    f"tenant {name!r}: config.tenant={c.tenant!r} "
                    f"disagrees with its key in the tenants dict")
        unknown = sorted(set(tenant_quota or {}) - set(tenants))
        if unknown:
            raise ValueError(
                f"tenant_quota names unknown tenant(s) {unknown}; known "
                f"tenants are {sorted(tenants)}")
        self._specs = dict(tenants)
        self._sessions: Dict[str, Any] = {}
        self._paths: Dict[str, str] = {}
        for name, spec in tenants.items():
            sess, path = _build_session(spec.runtime, spec.params,
                                        spec.cost, spec.config,
                                        mesh=spec.mesh)
            self._sessions[name] = sess
            self._paths[name] = path
        self._clock = clock if clock is not None else time.monotonic
        self._sched = RequestScheduler(
            batch_size=1, max_queue=max_queue,
            batch_deadline_ms=batch_deadline_ms, shed_policy=shed_policy,
            clock=self._clock,
            tenant_batch_size={n: s.config.batch_size
                               for n, s in tenants.items()},
            tenant_quota=dict(tenant_quota or {}))
        self._closed = False
        self._t0 = time.perf_counter()
        self._final: Optional[Dict[str, ServeReport]] = None

    @property
    def tenants(self):
        return sorted(self._specs)

    @property
    def scheduler(self) -> RequestScheduler:
        return self._sched

    @property
    def pending(self) -> int:
        return self._sched.pending

    def submit(self, tenant: str, samples, *, priority: int = 0,
               deadline_ms: Optional[float] = None) -> int:
        """Offer samples on behalf of ``tenant``; returns how many were
        admitted (quota/queue shedding may refuse some)."""
        if self._closed:
            raise RuntimeError(
                "MultiTenantEngine is closed; create a new one")
        if tenant not in self._specs:
            raise KeyError(
                f"unknown tenant {tenant!r}; known tenants are "
                f"{sorted(self._specs)}")
        if isinstance(samples, dict):
            samples = [samples]
        accepted = 0
        for s in samples:
            if self._sched.offer(s, priority=priority,
                                 deadline_ms=deadline_ms, tenant=tenant):
                accepted += 1
        self._pump()
        return accepted

    def tick(self) -> int:
        """Shed expired requests and close deadline-due partial batches;
        returns samples served by this tick."""
        if self._closed:
            raise RuntimeError(
                "MultiTenantEngine is closed; create a new one")
        return self._pump()

    def _pump(self) -> int:
        served = 0
        for reqs in self._sched.poll():
            self._sessions[reqs[0].tenant].push([r.sample for r in reqs])
            self._sched.complete(reqs)
            served += len(reqs)
        return served

    def close(self) -> Dict[str, ServeReport]:
        """Flush the shared queue (batches stay tenant-pure), drain every
        session, and return per-tenant reports. Idempotent."""
        if self._closed:
            return self._final
        for reqs in self._sched.flush():
            self._sessions[reqs[0].tenant].push([r.sample for r in reqs])
            self._sched.complete(reqs)
        wall = time.perf_counter() - self._t0
        snap = self._sched.snapshot()
        per_tenant = snap.get("tenants", {})
        out = {}
        for name, sess in self._sessions.items():
            sess.drain()
            raw = sess.result()
            raw["tenant"] = name
            raw["scheduler"] = {**snap,
                                "tenant": per_tenant.get(name)}
            out[name] = ServeReport.from_raw(
                raw, path=self._paths[name],
                num_layers=self._specs[name].cost.num_layers, wall_s=wall)
        self._final = out
        self._closed = True
        return out

    def __enter__(self) -> "MultiTenantEngine":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        return False


__all__ = [
    "Engine",
    "MultiTenantEngine",
    "ServeReport",
    "ServingConfig",
    "TenantSpec",
    "serve",
]
