"""Edge/cloud serving runtimes of the port.

The supported surface is the unified API (`serving/api.py`): declare a
`ServingConfig`, call `serve(runtime, params, stream, cost, config)` for
an offline stream or drive an `Engine` push-session for request-level
traffic, and read the typed `ServeReport`; ``workload="decode"`` with a
`DecodeRuntime` serves autoregressive generation. The sharded runtime
(serving/sharded.py: R replicas of a `launch.mesh.ServingMesh`, the
depth-K offload pipeline) is reached through ``serve(..., mesh=)`` or a
config with ``path="sharded"``, ``replicas > 1`` or ``mesh=True``; the
reference's deprecated ``serve_stream_sharded`` wrapper is not carried
over. The distributed runtime is not ported.
"""
from repro_torch.serving.simulator import (  # noqa: F401
    EdgeCloudRuntime, _serve_stream_sequential)
from repro_torch.serving.batched import (  # noqa: F401
    OffloadQueue, PendingFlush, _serve_stream_batched)
from repro_torch.serving.decode import DecodeRuntime  # noqa: F401
from repro_torch.serving.offload_codec import EncodedRows, OffloadCodec
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
    # request scheduling (Engine sessions)
    "Request",
    "RequestScheduler",
]
