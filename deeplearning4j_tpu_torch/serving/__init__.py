"""Continuous-batching serving for the port: slot and block-paged pools,
the prefix cache, scheduler (generation and embedding requests), engine,
persisted probe verdicts, the grammar and sampling surface, fault
injection, tenancy, metrics and the HTTP server."""

from deeplearning4j_tpu_torch.serving.cache_pool import (
    KVSlotPool,
    PagedKVPool,
)
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.serving.faults import (
    EngineCrash,
    FaultInjector,
    PermanentFault,
    TransientFault,
)
from deeplearning4j_tpu_torch.serving.grammar import (
    GrammarCache,
    GrammarError,
    GrammarTable,
    StopMatcher,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache, Segment
from deeplearning4j_tpu_torch.serving.probe_cache import ProbeCache
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionError,
    Backpressure,
    EmbeddingRequest,
    Request,
    RequestScheduler,
    RequestStatus,
)
from deeplearning4j_tpu_torch.serving.server import ServingServer
from deeplearning4j_tpu_torch.serving.tenancy import (
    QuotaExceeded,
    TenantConfig,
    TenantRegistry,
)

__all__ = [
    "AdmissionError", "Backpressure", "EmbeddingRequest", "EngineCrash",
    "FaultInjector",
    "GrammarCache", "GrammarError", "GrammarTable", "KVSlotPool",
    "PagedKVPool", "PermanentFault", "PrefixCache", "ProbeCache",
    "QuotaExceeded",
    "Request", "RequestScheduler", "RequestStatus", "Segment",
    "ServingEngine", "ServingMetrics", "ServingServer", "StopMatcher",
    "TenantConfig", "TenantRegistry", "TransientFault",
]
