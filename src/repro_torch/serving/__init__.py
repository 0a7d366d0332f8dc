"""Edge/cloud serving runtimes of the port.

The supported surface is the unified API (`serving/api.py`): declare a
`ServingConfig`, call `serve(runtime, params, stream, cost, config)` for
an offline stream or drive an `Engine` push-session for request-level
traffic, and read the typed `ServeReport`; ``workload="decode"`` with a
`DecodeRuntime` serves autoregressive generation. The sharded runtime
(serving/sharded.py: R replicas of a `launch.mesh.ServingMesh`, the
depth-K offload pipeline) is reached through ``serve(..., mesh=)`` or a
config with ``path="sharded"``, ``replicas > 1`` or ``mesh=True``; the
distributed runtime (serving/distributed.py: one process of a cluster,
its slice of every micro-batch, the bandit merged over a host-side KV
exchange, optionally fault-tolerant) through ``path="distributed"``,
``distributed=True`` or ``fault_tolerant=True`` in every process of the
cluster. The reference's deprecated ``serve_stream_sharded`` and
``serve_stream_distributed`` wrappers are not carried over.
"""
from repro_torch.serving.simulator import (  # noqa: F401
    EdgeCloudRuntime, _serve_stream_sequential)
from repro_torch.serving.batched import (  # noqa: F401
    OffloadQueue, PendingFlush, _serve_stream_batched)
from repro_torch.serving.decode import DecodeRuntime  # noqa: F401
from repro_torch.serving.offload_codec import EncodedRows, OffloadCodec
from repro_torch.serving.kvstore import CoordinatorKV, FileKV, KVTimeout
from repro_torch.serving.faults import (FAULT_KILL_EXIT, FaultInjector,
                                        parse_fault_plan)
from repro_torch.serving.distributed import (
    ClusterReport, CoordinatorExchange, FencedHostError, LoopbackExchange,
    ResilientExchange, ft_serving_context, init_distributed_from_env,
    make_resilient_exchange, run_distributed_subprocesses,
    run_supervised_cluster, start_worker_heartbeat)
from repro_torch.serving.scheduler import Request, RequestScheduler
from repro_torch.serving.api import (Engine, MultiTenantEngine, ServeReport,
                                     ServingConfig, TenantSpec, serve)

__all__ = [
    # unified serving API (the supported surface)
    "Engine",
    "MultiTenantEngine",
    "ServeReport",
    "ServingConfig",
    "TenantSpec",
    "serve",
    # runtime building blocks
    "DecodeRuntime",
    "EdgeCloudRuntime",
    "EncodedRows",
    "OffloadCodec",
    "OffloadQueue",
    "PendingFlush",
    # distributed serving: KV transports, fault plans, exchanges, clusters
    "ClusterReport",
    "CoordinatorExchange",
    "CoordinatorKV",
    "FAULT_KILL_EXIT",
    "FaultInjector",
    "FencedHostError",
    "FileKV",
    "KVTimeout",
    "LoopbackExchange",
    "ResilientExchange",
    "ft_serving_context",
    "init_distributed_from_env",
    "make_resilient_exchange",
    "parse_fault_plan",
    "run_distributed_subprocesses",
    "run_supervised_cluster",
    "start_worker_heartbeat",
    # request scheduling (Engine sessions)
    "Request",
    "RequestScheduler",
]
