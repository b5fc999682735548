"""Routing policies: which replica serves the next call.

A policy ranks the pool's *available* replicas (breaker-admitted,
not excluded by the caller); the pool applies it in
:meth:`~pytensor_federated_torch.routing.pool.NodePool.pick`.  Policies
see a narrow read-only view of each replica:

- ``queue_depth()`` — the replica's ADVERTISED backlog from its last
  fresh GetLoad reply (server batcher queue depth, else in-flight RPC
  count, else ``n_clients``), or ``None`` when the load is unknown or
  stale (stale-load eviction, pool.py);
- ``ewma_latency_s`` — exponentially-weighted per-request latency
  observed by THIS driver's own calls (None until the first call);
- ``inflight`` — this driver's own in-flight calls to the replica
  (the local fallback signal when no load has been advertised).

Three built-ins:

- **round_robin** — cycle in registration order; the predictable
  baseline and the right choice for homogeneous replicas + uniform
  requests.
- **ewma** — lowest observed EWMA latency first; adapts to replicas
  that are alive-but-slow (which never trip a breaker).  Unmeasured
  replicas rank FIRST (optimistically) so new capacity gets probed.
- **p2c** (default) — power-of-two-choices over advertised queue
  depth: sample two random candidates, route to the less loaded one
  (ties: lower EWMA latency, then random).  The classic
  load-balancing result: two random choices get exponentially close
  to least-loaded routing without the herd behavior of deterministic
  least-loaded (every driver dog-piling the one idle replica between
  load refreshes).
"""

from __future__ import annotations

import random
import threading
from typing import TYPE_CHECKING, List, Optional, Sequence

if TYPE_CHECKING:  # import cycle: pool imports get_policy
    from .pool import Replica

__all__ = [
    "EwmaLatencyPolicy",
    "PowerOfTwoChoicesPolicy",
    "RoundRobinPolicy",
    "get_policy",
]


def _depth(replica: "Replica") -> float:
    """Advertised queue depth from a fresh load reply, else this
    driver's OWN in-flight count toward the replica — the local
    fallback signal for lanes that advertise liveness only (TCP) or
    whose load went stale.  The two scales differ (server-wide backlog
    vs one driver's outstanding calls), but both rank 'more loaded'
    upward, which is all power-of-two-choices needs."""
    d = replica.queue_depth()
    if d is not None:
        return float(d)
    return float(replica.inflight)


class RoundRobinPolicy:
    """Cycle through candidates in registration order."""

    name = "round_robin"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counter = 0

    def pick(self, candidates: Sequence, k: int = 1) -> List:
        if not candidates:
            return []
        with self._lock:
            start = self._counter
            self._counter += 1
        n = len(candidates)
        return [candidates[(start + i) % n] for i in range(min(k, n))]


class EwmaLatencyPolicy:
    """Lowest observed EWMA latency first; unmeasured replicas first
    of all (optimism: new/idle capacity must receive traffic to ever
    be measured)."""

    name = "ewma"

    def pick(self, candidates: Sequence, k: int = 1) -> List:
        ranked = sorted(
            candidates,
            key=lambda r: (
                r.ewma_latency_s is not None,  # unmeasured first
                r.ewma_latency_s or 0.0,
            ),
        )
        return list(ranked[:k])


class PowerOfTwoChoicesPolicy:
    """Two random candidates, route to the lower advertised queue
    depth (ties/unknown: lower EWMA, then the sampling order)."""

    name = "p2c"

    def __init__(self, rng: Optional[random.Random] = None) -> None:
        self._rng = rng or random.Random()

    def _better(self, a: "Replica", b: "Replica") -> "Replica":
        da, db = _depth(a), _depth(b)
        if da != db:
            return a if da < db else b
        ea, eb = a.ewma_latency_s, b.ewma_latency_s
        if ea is not None and eb is not None and ea != eb:
            return a if ea < eb else b
        return a

    def pick(self, candidates: Sequence, k: int = 1) -> List:
        pool = list(candidates)
        out: List = []
        while pool and len(out) < k:
            if len(pool) == 1:
                choice = pool[0]
            else:
                a, b = self._rng.sample(pool, 2)
                choice = self._better(a, b)
            out.append(choice)
            pool.remove(choice)
        return out


_POLICIES = {
    "round_robin": RoundRobinPolicy,
    "ewma": EwmaLatencyPolicy,
    "p2c": PowerOfTwoChoicesPolicy,
}


def get_policy(policy: object) -> object:
    """A policy instance from a name ("p2c" default, "round_robin",
    "ewma") or a pre-built object exposing ``pick(candidates, k)``."""
    if isinstance(policy, str):
        try:
            return _POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown routing policy {policy!r}; "
                f"choose from {sorted(_POLICIES)}"
            ) from None
    if not hasattr(policy, "pick"):
        raise TypeError(
            f"policy must be a name or expose .pick(candidates, k); "
            f"got {type(policy).__name__}"
        )
    return policy
