"""Online streaming preprocessing (Piper-as-a-service).

Counterpart of ``repro/stream/__init__.py``. Offline, the two-loop engine
maximizes throughput over a finite dataset. This package is the *online*
execution mode: a long-lived service running loop ② with a frozen
(offline-built, incrementally refreshable) vocabulary over a continuous
request stream — latency-bound, fixed-shape, backpressured.

  * ``scheduler`` — micro-batch coalescing into bucketed fixed shapes
    with per-request result routing, through pinned staging buffers;
  * ``service``   — the service loop: bounded ingress, double-buffered
    dispatch on the service's own CUDA stream, atomic vocab refresh,
    graceful drain;
  * ``metrics``   — rows/s + p50/p95/p99 request-latency accounting.
"""

from repro_torch.stream.metrics import ServiceMetrics
from repro_torch.stream.scheduler import (
    DEFAULT_BUCKET_ROWS,
    CompositeRequest,
    MicroBatchScheduler,
    StreamRequest,
    make_request,
)
from repro_torch.stream.service import StreamingPreprocessService

__all__ = [
    "DEFAULT_BUCKET_ROWS",
    "CompositeRequest",
    "MicroBatchScheduler",
    "ServiceMetrics",
    "StreamRequest",
    "StreamingPreprocessService",
    "make_request",
]
