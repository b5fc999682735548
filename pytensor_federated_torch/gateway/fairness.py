"""Per-tenant fairness for the gateway tier: quotas + weighted-fair queueing.

The accept tier (:mod:`.server`) holds thousands of downstream
connections on one loop, which means one misbehaving client — a hog
tenant replaying a tight loop — can fill every upstream window and
starve everyone else while each individual request still looks
perfectly legal.  The nodes carry the *server-side* shield
(deadlines, shedding admission, retry budgets); this module is the
*front-door* half, metering by TENANT identity (the new wire field: npwire flag
bit 32 / npproto field 19 / shm doorbell flag bit 8, declared in
:mod:`..service.wire_registry`) instead of by connection:

- :class:`TokenBucket` — per-tenant admission quota (monotonic-clock
  token bucket, the :class:`~..routing.budget.RetryBudget` shape).  A
  tenant past its rate is DENIED loudly: an in-band retryable error
  carrying :data:`OVERLOAD_ERROR_PREFIX` plus the tenant id, a
  ``pftpu_gateway_denials_total{tenant, reason}`` tick, and a
  ``gateway.denied`` flight-recorder point — never silent drops, never
  an unbounded queue.
- :class:`WeightedFairQueue` — deficit round robin (DRR) over
  per-tenant FIFO queues.  Each backlogged tenant is visited once per
  round and accumulates ``weight x quantum`` deficit per visit, so ANY
  active tenant with backlog is served within a bounded number of
  pops: at most ``ceil(1 / quantum_t) x n_active`` pops after it
  becomes head-of-round (property-tested) —
  the no-starvation contract a plain shared FIFO cannot make.
- :class:`TenantFairness` — the composition the gateway server drives:
  ``admit()`` at frame arrival (quota + per-tenant backlog bound),
  ``push()``/``pop()`` around the upstream coalescing loop.

Single-owner by design: the gateway's asyncio loop is the only caller
of ``admit``/``push``/``pop`` (no locks on the hot path); the metric
families are process-global like every other ``pftpu_*`` family.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, Optional, Tuple

from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics

__all__ = [
    "OVERLOAD_ERROR_PREFIX",
    "TokenBucket",
    "WeightedFairQueue",
    "TenantFairness",
    "is_overload_error",
    "overload_error",
]

#: The in-band error classification for gateway denials (quota or
#: backlog).  RETRYABLE on purpose — the caller's work is fine, the
#: front door is momentarily full — which is the opposite posture of
#: the deadline classification (whose budget is gone everywhere at
#: once); clients that understand the marker may back off and re-send.
OVERLOAD_ERROR_PREFIX = "gateway overloaded"


def overload_error(tenant: str, detail: str) -> str:
    """The in-band denial string: classification marker + the tenant
    it applies to (the loudness contract: every denial names its
    tenant, in-band and in telemetry)."""
    return f"{OVERLOAD_ERROR_PREFIX} [tenant {tenant}]: {detail}"


def is_overload_error(error: Optional[str]) -> bool:
    """Whether a reply's in-band error is the gateway-denial
    classification (substring, like ``deadline.is_deadline_error``:
    lanes may wrap it in their own stage prefixes)."""
    return error is not None and OVERLOAD_ERROR_PREFIX in error


# -- gateway metric families ----------------------------------------------

GATEWAY_REQUESTS = _metrics.counter(
    "pftpu_gateway_requests_total",
    "Requests entering the gateway accept tier, by outcome",
    ("outcome",),
)
GATEWAY_DENIALS = _metrics.counter(
    "pftpu_gateway_denials_total",
    "Requests denied at the gateway front door, by tenant and reason",
    ("tenant", "reason"),
)
GATEWAY_SHED = _metrics.counter(
    "pftpu_gateway_shed_total",
    "Requests shed by the gateway before upstream dispatch, by reason",
    ("reason",),
)
GATEWAY_QUEUE_DEPTH = _metrics.gauge(
    "pftpu_gateway_queue_depth",
    "Requests queued in the gateway's weighted-fair queue, by tenant",
    ("tenant",),
)


class TokenBucket:
    """Monotonic-clock token bucket (the retry-budget shape,
    :mod:`..routing.budget`): ``try_spend`` refills lazily from wall
    time and never blocks.  ``rate_per_s`` tokens accrue per second up
    to ``burst``; a spend past the balance is a denial."""

    def __init__(
        self,
        rate_per_s: float = 100.0,
        burst: float = 200.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError(
                f"need rate_per_s > 0 and burst > 0, got "
                f"{rate_per_s}/{burst}"
            )
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self._clock: Callable[[], float] = (
            clock if clock is not None else time.monotonic
        )
        self._tokens = self.burst
        self._last = float(self._clock())

    def _refill(self) -> None:
        now = float(self._clock())
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate_per_s
        )
        self._last = now

    def tokens(self) -> float:
        self._refill()
        return self._tokens

    def try_spend(self, cost: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= cost:
            self._tokens -= cost
            return True
        return False


class _TenantState:
    """One tenant's DRR bookkeeping: FIFO backlog + deficit counter."""

    __slots__ = ("queue", "deficit", "weight")

    def __init__(self, weight: float) -> None:
        self.queue: Deque[object] = deque()
        self.deficit = 0.0
        self.weight = weight


class WeightedFairQueue:
    """Deficit-round-robin fair queue over per-tenant FIFOs.

    ``pop`` serves the round-robin head tenant while its deficit
    covers one request (cost 1.0), recharging ``weight x quantum`` per
    round-trip through the active ring.  With every weight >=
    ``min_weight`` (enforced), a backlogged tenant is served within
    ``ceil(1 / (min_weight x quantum)) x n_active`` pops — the bounded
    no-starvation property the tests pin.

    Not thread-safe: owned by the gateway's event loop (module
    docstring)."""

    #: Weights below this are clamped up: a zero weight would make the
    #: DRR ring spin forever without serving (and "present but starved
    #: by configuration" is exactly what this queue exists to forbid).
    MIN_WEIGHT = 0.01

    def __init__(
        self,
        *,
        quantum: float = 1.0,
        default_weight: float = 1.0,
        weights: Optional[Dict[str, float]] = None,
    ) -> None:
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self.quantum = float(quantum)
        self.default_weight = max(float(default_weight), self.MIN_WEIGHT)
        self._weights = {
            t: max(float(w), self.MIN_WEIGHT)
            for t, w in (weights or {}).items()
        }
        # Insertion-ordered ring of tenants with backlog; rotation is
        # pop-from-front/push-to-back on the key list.
        self._states: Dict[str, _TenantState] = {}
        self._active: "OrderedDict[str, None]" = OrderedDict()
        self._depth = 0

    def weight_of(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def set_weight(self, tenant: str, weight: float) -> None:
        w = max(float(weight), self.MIN_WEIGHT)
        self._weights[tenant] = w
        state = self._states.get(tenant)
        if state is not None:
            state.weight = w

    def depth(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return self._depth
        state = self._states.get(tenant)
        return 0 if state is None else len(state.queue)

    def active_tenants(self) -> Tuple[str, ...]:
        return tuple(self._active)

    def push(self, tenant: str, item: object) -> None:
        state = self._states.get(tenant)
        if state is None:
            state = self._states[tenant] = _TenantState(
                self.weight_of(tenant)
            )
        state.queue.append(item)
        self._depth += 1
        if tenant not in self._active:
            self._active[tenant] = None
        GATEWAY_QUEUE_DEPTH.labels(tenant=tenant).set(len(state.queue))

    def push_front(self, tenant: str, item: object) -> None:
        """Head re-insert for an item POPPED but not dispatched (the
        window byte-cap hit): preserves the per-tenant FIFO contract —
        a plain ``push`` would reorder it behind its own siblings and
        let continuous traffic defer a large frame forever — and gives
        back the DRR deficit its pop spent (the deferral served
        nobody)."""
        state = self._states.get(tenant)
        if state is None:
            state = self._states[tenant] = _TenantState(
                self.weight_of(tenant)
            )
        state.queue.appendleft(item)
        state.deficit += 1.0
        self._depth += 1
        if tenant not in self._active:
            self._active[tenant] = None
        GATEWAY_QUEUE_DEPTH.labels(tenant=tenant).set(len(state.queue))

    def pop(self) -> Optional[Tuple[str, object]]:
        """Serve one request fairly, or ``None`` when idle.  Bounded
        work per call: each ring pass either serves or adds quantum to
        every visited tenant, so the loop ends within
        ``ceil(1 / (min_weight x quantum))`` passes."""
        if self._depth == 0:
            return None
        while True:
            tenant, _ = next(iter(self._active.items()))
            state = self._states[tenant]
            if not state.queue:
                # A drained tenant leaves the ring, the state map, AND
                # the queue-depth label set — its deficit resets
                # (DRR's anti-burst rule) and its bookkeeping must not
                # accumulate per distinct tenant id forever (the id is
                # attacker-controlled wire input).
                del self._active[tenant]
                del self._states[tenant]
                GATEWAY_QUEUE_DEPTH.remove(tenant=tenant)
                continue
            if state.deficit < 1.0:
                state.deficit += state.weight * self.quantum
                self._active.move_to_end(tenant)
                continue
            state.deficit -= 1.0
            item = state.queue.popleft()
            self._depth -= 1
            GATEWAY_QUEUE_DEPTH.labels(tenant=tenant).set(
                len(state.queue)
            )
            if not state.queue:
                del self._active[tenant]
                del self._states[tenant]
                GATEWAY_QUEUE_DEPTH.remove(tenant=tenant)
            return tenant, item


class TenantFairness:
    """Quota + fair-queue admission, the gateway server's one policy
    object.

    ``quota_rate_per_s``/``quota_burst``: each tenant's token bucket
    (``None`` rate = unmetered, fairness still applies through the
    queue).  ``max_backlog_per_tenant`` bounds one tenant's queued
    requests — a hog tenant faster than its quota fills ITS backlog
    and gets denied, while other tenants' queues stay shallow.
    ``weights`` biases DRR service (a paying tenant can be worth 4x a
    free one); unnamed tenants get ``default_weight``.

    ``max_tenants`` bounds the number of CONCURRENTLY TRACKED tenant
    ids.  The tenant id is attacker-controlled wire input, so without
    a bound a client rotating fresh ids per request would mint itself
    a new full token bucket (and a new metric label child) every call
    — evading the quota entirely and growing state without limit.  At
    the cap, an unseen id first tries to reclaim an IDLE slot (a
    bucket back at full burst loses nothing by eviction — it is
    indistinguishable from a fresh one); failing that, the request is
    denied loudly with ``reason="tenant_cardinality"`` under the
    bounded ``(overflow)`` metric label (the real id still travels in
    the in-band error, where cardinality costs nothing)."""

    #: The metric-label stand-in for ids past the cardinality cap —
    #: raw attacker-chosen ids must never become metric labels.
    OVERFLOW_LABEL = "(overflow)"

    def __init__(
        self,
        *,
        quota_rate_per_s: Optional[float] = None,
        quota_burst: Optional[float] = None,
        max_backlog_per_tenant: int = 256,
        quantum: float = 1.0,
        default_weight: float = 1.0,
        weights: Optional[Dict[str, float]] = None,
        max_tenants: int = 1024,
    ) -> None:
        self.quota_rate_per_s = quota_rate_per_s
        self.quota_burst = (
            float(quota_burst)
            if quota_burst is not None
            else (2.0 * quota_rate_per_s if quota_rate_per_s else 0.0)
        )
        self.max_backlog_per_tenant = int(max_backlog_per_tenant)
        self.queue = WeightedFairQueue(
            quantum=quantum,
            default_weight=default_weight,
            weights=weights,
        )
        self.max_tenants = int(max_tenants)
        self._buckets: Dict[str, TokenBucket] = {}

    def _evict_idle_bucket(self) -> bool:
        """Reclaim one slot from a tenant whose bucket refilled to
        full burst (idle long enough to lose nothing by eviction)."""
        for tenant, bucket in self._buckets.items():
            if (
                bucket.tokens() >= bucket.burst
                and not self.queue.depth(tenant)
            ):
                del self._buckets[tenant]
                return True
        return False

    def bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        if self.quota_rate_per_s is None:
            return None
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = TokenBucket(
                rate_per_s=self.quota_rate_per_s, burst=self.quota_burst
            )
        return bucket

    def _is_tracked(self, tenant: str) -> bool:
        """Whether this tenant already holds fairness state (a quota
        bucket or queued backlog)."""
        return tenant in self._buckets or self.queue.depth(tenant) > 0

    def _n_tracked(self) -> int:
        """Distinct tenants currently holding fairness state.  The
        cardinality cap must count BOTH maps: with quotas disabled no
        buckets ever exist, and a cap keyed on buckets alone would be
        inert — rotating ids would mint unlimited per-tenant backlog
        allowances (total queue memory unbounded)."""
        return len(self._buckets.keys() | self.queue._states.keys())

    def admit(self, tenant: str) -> Optional[str]:
        """Admission verdict for one arriving request: ``None`` admits;
        a string is the in-band denial error (already metered and
        flight-recorded, always naming the tenant)."""
        if (
            not self._is_tracked(tenant)
            and self._n_tracked() >= self.max_tenants
            and not self._evict_idle_bucket()
        ):
            GATEWAY_DENIALS.labels(
                tenant=self.OVERFLOW_LABEL, reason="tenant_cardinality"
            ).inc()
            GATEWAY_REQUESTS.labels(outcome="denied_cardinality").inc()
            _flightrec.record(
                "gateway.denied",
                tenant=self.OVERFLOW_LABEL,
                reason="tenant_cardinality",
            )
            return overload_error(
                tenant,
                f"tenant table full ({self.max_tenants} active "
                "tenants); retry later",
            )
        bucket = self.bucket_for(tenant)
        if bucket is not None and not bucket.try_spend():
            GATEWAY_DENIALS.labels(tenant=tenant, reason="quota").inc()
            GATEWAY_REQUESTS.labels(outcome="denied_quota").inc()
            _flightrec.record(
                "gateway.denied", tenant=tenant, reason="quota"
            )
            return overload_error(
                tenant,
                f"quota exhausted ({self.quota_rate_per_s}/s, "
                f"burst {self.quota_burst:g}); retry later",
            )
        if self.queue.depth(tenant) >= self.max_backlog_per_tenant:
            GATEWAY_DENIALS.labels(tenant=tenant, reason="backlog").inc()
            GATEWAY_REQUESTS.labels(outcome="denied_backlog").inc()
            _flightrec.record(
                "gateway.denied", tenant=tenant, reason="backlog"
            )
            return overload_error(
                tenant,
                f"backlog full ({self.max_backlog_per_tenant} queued); "
                "retry later",
            )
        return None
