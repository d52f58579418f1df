"""Observability for the port (its own copies of the reference's
``deeplearning4j_tpu/obs/`` modules): the span tracer with Chrome-trace
export, the crash flight recorder, structured JSON logs, the step-scoped
``torch.profiler`` trigger, trace merging and the metrics registry."""

from deeplearning4j_tpu_torch.obs.collect import (  # noqa: F401
    merge_trace_files,
    merge_traces,
)
from deeplearning4j_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    redact,
)
from deeplearning4j_tpu_torch.obs.logs import (  # noqa: F401
    JsonLogFormatter,
    configure_json_logging,
    log_event,
)
from deeplearning4j_tpu_torch.obs.profiler import ProfileTrigger  # noqa: F401
from deeplearning4j_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
)
from deeplearning4j_tpu_torch.obs.trace import (  # noqa: F401
    Tracer,
    format_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
    slot_track,
)
