"""Continuous-batching serving for the port: slot and block-paged pools,
the prefix cache, scheduler (generation, embedding and KV-wire requests),
engine, persisted probe verdicts, the grammar and sampling surface, fault
injection, tenancy, metrics and the HTTP server; the KV wire format
(``disagg``), the fleet's RPC primitives (``rpc``), the network chaos proxy
(``netfaults``), the prefix-affinity replica router and the disaggregated
fleet controller.

The names load on first use: the router and the controller (and the wire,
RPC and chaos modules) import no ``torch``, so a router process loads no
model stack."""

from importlib import import_module

_WHERE = {
    "KVSlotPool": "cache_pool", "PagedKVPool": "cache_pool",
    "FleetController": "controller", "RoleBalancer": "controller",
    "WIRE_VERSION": "disagg", "WireError": "disagg",
    "decode_segment": "disagg", "encode_segment": "disagg",
    "model_config_hash": "disagg",
    "ServingEngine": "engine", "run_request_trace": "engine",
    "EngineCrash": "faults", "FaultInjector": "faults",
    "PermanentFault": "faults", "TransientFault": "faults",
    "GrammarCache": "grammar", "GrammarError": "grammar",
    "GrammarTable": "grammar", "StopMatcher": "grammar",
    "ServingMetrics": "metrics",
    "ChaosProxy": "netfaults",
    "PrefixCache": "prefix_cache", "Segment": "prefix_cache",
    "ProbeCache": "probe_cache",
    "ReplicaRouter": "router",
    "CircuitBreaker": "rpc", "Deadline": "rpc",
    "IdempotencyRegistry": "rpc", "LatencyWindow": "rpc",
    "run_hedged": "rpc",
    "AdmissionError": "scheduler", "Backpressure": "scheduler",
    "EmbeddingRequest": "scheduler", "KVExportRequest": "scheduler",
    "KVIngestRequest": "scheduler", "KVSessionRequest": "scheduler",
    "Request": "scheduler", "RequestScheduler": "scheduler",
    "RequestStatus": "scheduler",
    "ServingServer": "server",
    "QuotaExceeded": "tenancy", "TenantConfig": "tenancy",
    "TenantRegistry": "tenancy",
}

__all__ = sorted(_WHERE)


def __getattr__(name: str):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_WHERE))
