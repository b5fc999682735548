"""Per-pool retry budgets: failure amplification as a rationed resource.

Every recovery mechanism this package grew — transport retries, hedged
requests, mid-window failover, fanout member re-runs — MULTIPLIES load
exactly when the pool is least able to absorb it: a pool that is slow
because it is overloaded invites retries, which make it slower, which
invites more retries.  That feedback loop is the canonical overload
collapse (the Google SRE "retry storm"), and the fix is the same
everywhere: recovery attempts spend from a RATE-LIMITED budget, so a
healthy pool retries freely while a sick one organically degrades
toward one attempt per call instead of several.

:class:`RetryBudget` is a thread-safe token bucket over
``time.monotonic()``: ``burst`` tokens of headroom, refilled at
``rate_per_s``.  Spends are booked by
:meth:`~pytensor_federated_torch.routing.pool.NodePool.allow_retry` —
the single choke point the hedging lane, the failover loops, and
``fanout_exec.run_members`` all charge — and a denial is LOUD:
``pftpu_retry_budget_spend_total{outcome="denied"}`` plus a
``budget.exhausted`` flight event, so an operator sees amplification
being refused, not just latency mysteriously rising.  Budgets
reconverge by construction: once load drops the bucket refills and
recovery behavior returns to normal (the chaos overload lane asserts
exactly that).

First attempts are NEVER charged — the budget rations the multiplier,
not the work.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics

__all__ = ["RetryBudget"]

_SPEND = _metrics.counter(
    "pftpu_retry_budget_spend_total",
    "Retry/hedge budget spend attempts, by kind and outcome",
    ("what", "outcome"),
)
_TOKENS = _metrics.gauge(
    "pftpu_retry_budget_tokens",
    "Tokens currently available in the retry budget, by budget name",
    ("name",),
)


class RetryBudget:
    """A token bucket rationing retry/hedge amplification.

    ``rate_per_s`` is the sustained amplification a pool tolerates
    (extra attempts per second, across all callers sharing the
    budget); ``burst`` the headroom for transient blips.  The defaults
    — 4/s sustained, 16 burst — absorb the occasional failover or
    hedge without ever letting a persistent failure multiply load by
    more than ``rate_per_s`` attempts a second.

    Thread-safe (callers include event loops, worker threads, and the
    fanout member pool); ``try_spend`` never blocks — a denied spend
    returns ``False`` and the caller degrades to its single-attempt
    behavior.
    """

    def __init__(
        self,
        rate_per_s: float = 4.0,
        burst: float = 16.0,
        *,
        name: str = "pool",
    ) -> None:
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self.name = name
        self._tokens = float(burst)
        self._t_last = time.monotonic()
        self._lock = threading.Lock()
        # Plain always-on tallies (the metrics are no-ops with
        # telemetry off; the chaos harness reconciles against these).
        self.n_granted = 0
        self.n_denied = 0

    def _refill(self, now: float) -> None:
        self._tokens = min(
            self.burst,
            self._tokens + (now - self._t_last) * self.rate_per_s,
        )
        self._t_last = now

    def try_spend(self, n: float = 1.0, *, what: str = "retry") -> bool:
        """Spend ``n`` tokens if available.  ``False`` = the budget is
        exhausted: the caller must NOT amplify (skip the hedge, stop
        the failover loop) — booked loudly in metrics and the flight
        recorder so refused amplification is a visible signal."""
        now = time.monotonic()
        with self._lock:
            self._refill(now)
            ok = self._tokens >= n
            if ok:
                self._tokens -= n
                self.n_granted += 1
            else:
                self.n_denied += 1
            tokens = self._tokens
        _SPEND.labels(
            what=what, outcome="granted" if ok else "denied"
        ).inc()
        _TOKENS.labels(name=self.name).set(tokens)
        if not ok:
            _flightrec.record(
                "budget.exhausted", budget=self.name, what=what,
                tokens=round(tokens, 3),
            )
        return ok

    def refund(self, n: float = 1.0) -> None:
        """Return tokens from a granted spend that never amplified —
        e.g. a hedge grant with no replica to hedge onto.  The
        granted/denied tallies stay as booked (the chaos harness
        bounds ATTEMPTS by grants, and a refunded grant attempted
        nothing, so the bound stays conservative)."""
        now = time.monotonic()
        with self._lock:
            self._refill(now)
            self._tokens = min(self.burst, self._tokens + n)
            tokens = self._tokens
        _TOKENS.labels(name=self.name).set(tokens)

    def tokens(self) -> float:
        """Current token count (refilled to now) — the reconvergence
        probe the chaos harness polls after load drops."""
        now = time.monotonic()
        with self._lock:
            self._refill(now)
            return self._tokens

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "rate_per_s": self.rate_per_s,
            "burst": self.burst,
            "tokens": round(self.tokens(), 3),
            "granted_total": self.n_granted,
            "denied_total": self.n_denied,
        }
