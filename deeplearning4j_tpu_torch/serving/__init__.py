"""Continuous-batching serving for the port: slot and block-paged pools,
scheduler, engine, metrics and the HTTP server."""

from deeplearning4j_tpu_torch.serving.cache_pool import (
    KVSlotPool,
    PagedKVPool,
)
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionError,
    Backpressure,
    Request,
    RequestScheduler,
    RequestStatus,
)
from deeplearning4j_tpu_torch.serving.server import ServingServer

__all__ = [
    "AdmissionError", "Backpressure", "KVSlotPool", "PagedKVPool", "Request",
    "RequestScheduler", "RequestStatus", "ServingEngine", "ServingMetrics",
    "ServingServer",
]
