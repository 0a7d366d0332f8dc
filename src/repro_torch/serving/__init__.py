from repro_torch.serving.batched import (  # noqa: F401
    OffloadQueue, PendingFlush, _serve_stream_batched)
from repro_torch.serving.simulator import (  # noqa: F401
    EdgeCloudRuntime, _serve_stream_sequential)
