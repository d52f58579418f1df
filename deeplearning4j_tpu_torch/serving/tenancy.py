"""Multi-tenant serving: tenant registry, API-key resolution, and
token-rate quotas (the port's copy of
``deeplearning4j_tpu/serving/tenancy.py``; plain locks).

A *tenant* is one paying/priority class of traffic sharing the engine:
it carries a priority class (strict tier in the scheduler), a
weighted-fair share *within* that tier (deficit round-robin weight — see
``RequestScheduler``), a cap on concurrently held KV slots, a token-rate
quota (token bucket), and a default LoRA adapter index so a tenant's
fine-tune is selected by its API key alone.

Quotas are enforced at ``submit`` time — ``charge`` debits the bucket
with the request's token cost (prompt + max_new, the same unit the
scheduler budgets) and raises :class:`QuotaExceeded` when the bucket is
dry. ``QuotaExceeded`` subclasses ``Backpressure`` deliberately: every
existing shed-load path (the HTTP 429 mapping, the trace driver's
retry) already handles it, so quota enforcement needs zero new plumbing
downstream.

Thread-safe: HTTP handler threads resolve/charge concurrently while the
engine thread reads tenant config.
"""

from __future__ import annotations

import dataclasses
import json
import threading

from deeplearning4j_tpu_torch.analysis.sanitizers import (
    note_access,
    wrap_lock,
)
from deeplearning4j_tpu_torch.serving.scheduler import Backpressure


class QuotaExceeded(Backpressure):
    """Tenant token bucket dry — shed load upstream (HTTP 429).

    Subclasses ``Backpressure`` so every existing 429/retry path
    applies; catch this type specifically to label rejection metrics.
    """


@dataclasses.dataclass
class TenantConfig:
    """One tenant's serving contract.

    ``api_key`` None (or "") marks the ANONYMOUS tenant — requests
    without an ``X-API-Key`` header resolve to it (at most one per
    registry). ``priority`` is the strict scheduler class (0 most
    urgent); ``weight`` the deficit-round-robin share within that
    class. ``max_slots`` caps concurrently held KV slots (None =
    engine-wide limit only). ``rate`` is the sustained token budget in
    tokens/second with ``burst`` headroom (None = unmetered).
    ``default_adapter`` is the LoRA bank row applied when a request
    does not name one (0 = base model). ``slo_p99_tpot_s`` is the
    tenant's p99 time-per-output-token objective in seconds (None = no
    SLO); the metrics layer exports observed-p99 / objective as a
    burn-rate gauge (> 1 means the SLO is being violated)."""

    tenant_id: str
    api_key: str | None = None
    priority: int = 1
    weight: float = 1.0
    max_slots: int | None = None
    rate: float | None = None
    burst: float | None = None
    default_adapter: int = 0
    slo_p99_tpot_s: float | None = None

    def __post_init__(self):
        if not self.tenant_id:
            raise ValueError("tenant_id must be non-empty")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.tenant_id}: weight must be > 0, "
                f"got {self.weight}"
            )
        if self.max_slots is not None and self.max_slots < 1:
            raise ValueError(
                f"tenant {self.tenant_id}: max_slots must be >= 1"
            )
        if self.rate is not None:
            if self.rate <= 0:
                raise ValueError(
                    f"tenant {self.tenant_id}: rate must be > 0"
                )
            if self.burst is None:
                # default burst: one second of sustained rate — a
                # single max-size request should not need a cold wait
                self.burst = self.rate
            if self.burst <= 0:
                raise ValueError(
                    f"tenant {self.tenant_id}: burst must be > 0"
                )
        if self.default_adapter < 0:
            raise ValueError(
                f"tenant {self.tenant_id}: default_adapter must be >= 0"
            )
        if self.slo_p99_tpot_s is not None and self.slo_p99_tpot_s <= 0:
            raise ValueError(
                f"tenant {self.tenant_id}: slo_p99_tpot_s must be > 0"
            )


class TenantRegistry:
    """API-key -> tenant resolution plus per-tenant token buckets.

    ``clock`` is injectable (defaults to ``time.monotonic``) so refill
    behavior is testable without sleeping. Buckets start FULL (a new
    tenant can burst immediately — the steady-state constraint is the
    sustained rate, not the first request)."""

    def __init__(self, tenants, clock=None):
        if clock is None:
            import time

            clock = time.monotonic
        self._clock = clock
        self._by_id: dict[str, TenantConfig] = {}
        self._by_key: dict[str, TenantConfig] = {}
        self._anonymous: TenantConfig | None = None
        for t in tenants:
            if t.tenant_id in self._by_id:
                raise ValueError(f"duplicate tenant_id {t.tenant_id!r}")
            self._by_id[t.tenant_id] = t
            if not t.api_key:
                if self._anonymous is not None:
                    raise ValueError(
                        "at most one anonymous tenant (empty api_key)"
                    )
                self._anonymous = t
            else:
                if t.api_key in self._by_key:
                    raise ValueError(
                        f"duplicate api_key for tenant {t.tenant_id!r}"
                    )
                self._by_key[t.api_key] = t
        if not self._by_id:
            raise ValueError("registry needs at least one tenant")
        self._lock = wrap_lock(threading.Lock(), "tenancy._lock")
        # token buckets move under the lock: HTTP handler threads
        # charge concurrently
        self._buckets = {  # guarded-by: _lock
            t.tenant_id: {"level": float(t.burst), "t_last": clock()}
            for t in self._by_id.values()
            if t.rate is not None
        }

    # -- construction -------------------------------------------------

    @classmethod
    def from_json(cls, obj, clock=None) -> "TenantRegistry":
        """Build from a parsed JSON config: either a list of tenant
        objects or ``{"tenants": [...]}``. Keys: ``id`` (required),
        ``api_key``, ``priority``, ``weight``, ``max_slots``,
        ``rate_tokens_per_s``, ``burst_tokens``, ``default_adapter``,
        ``slo_p99_tpot_s``."""
        if isinstance(obj, dict):
            obj = obj["tenants"]
        tenants = []
        for item in obj:
            tenants.append(
                TenantConfig(
                    tenant_id=item["id"],
                    api_key=item.get("api_key"),
                    priority=int(item.get("priority", 1)),
                    weight=float(item.get("weight", 1.0)),
                    max_slots=item.get("max_slots"),
                    rate=item.get("rate_tokens_per_s"),
                    burst=item.get("burst_tokens"),
                    default_adapter=int(item.get("default_adapter", 0)),
                    slo_p99_tpot_s=item.get("slo_p99_tpot_s"),
                )
            )
        return cls(tenants, clock=clock)

    @classmethod
    def from_file(cls, path, clock=None) -> "TenantRegistry":
        with open(path) as f:
            return cls.from_json(json.load(f), clock=clock)

    # -- resolution ---------------------------------------------------

    def resolve_key(self, api_key: str | None) -> TenantConfig | None:
        """Tenant for an API key; falsy key -> the anonymous tenant;
        unknown key -> None (the HTTP layer maps that to 401)."""
        if not api_key:
            return self._anonymous
        return self._by_key.get(api_key)

    def get(self, tenant_id: str) -> TenantConfig | None:
        return self._by_id.get(tenant_id)

    def tenant_ids(self) -> list[str]:
        return list(self._by_id)

    def __len__(self) -> int:
        return len(self._by_id)

    # -- quota --------------------------------------------------------

    def charge(self, tenant_id: str, tokens: int) -> None:
        """Debit ``tokens`` from the tenant's bucket or raise
        :class:`QuotaExceeded`. Unmetered tenants (no rate) and unknown
        ids pass. All-or-nothing: a rejected request leaves the bucket
        untouched, so a flooding tenant cannot starve itself into
        blocking a later small request longer than the refill demands."""
        t = self._by_id.get(tenant_id)
        if t is None or t.rate is None:
            return
        now = self._clock()
        with self._lock:
            note_access("tenancy.buckets", write=True)
            b = self._buckets[tenant_id]
            b["level"] = min(
                float(t.burst), b["level"] + (now - b["t_last"]) * t.rate
            )
            b["t_last"] = now
            if b["level"] < tokens:
                raise QuotaExceeded(
                    f"tenant {tenant_id}: token-rate quota exhausted "
                    f"(need {tokens}, have {b['level']:.1f}; "
                    f"rate {t.rate}/s)"
                )
            b["level"] -= tokens

    def bucket_level(self, tenant_id: str) -> float | None:
        """Current bucket level (refilled to now) — observability only."""
        t = self._by_id.get(tenant_id)
        if t is None or t.rate is None:
            return None
        now = self._clock()
        with self._lock:
            b = self._buckets[tenant_id]
            return min(
                float(t.burst), b["level"] + (now - b["t_last"]) * t.rate
            )
