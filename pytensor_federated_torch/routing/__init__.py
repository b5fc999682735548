"""Replica-pool routing for the host-federation lane.

The reference balances once at connect time (GetLoad poll + least-
loaded pick, reference: service.py:240-263) and then pins: every call
rides whichever server the client first connected to, so one slow or
dead node stalls the whole graph.  This subsystem sits ABOVE both
transports (TCP ``service.tcp``, shared memory ``service.shm`` and
descriptor rings ``service.ring``; the gRPC lane is not ported yet)
and routes every call:

- :class:`NodePool` — the replica registry: static list plus late
  add/remove, background health probing over the zero-item TCP probe
  frame (which the shm and ring doorbells answer too), stale-load eviction, and one
  :class:`CircuitBreaker` per replica (half-open probing, jittered
  exponential backoff).
- :mod:`.policies` — pluggable pick policies: round-robin, EWMA
  latency, and power-of-two-choices over advertised queue depth
  (the default).
- :class:`PooledArraysClient` — the drop-in client facade: the same
  ``evaluate`` / ``evaluate_many`` surface as the pinned clients,
  plus hedged requests for idempotent computes and mid-window
  failover that re-queues the un-replied tail of a pipelined window
  onto a healthy replica.
- :class:`RetryBudget` — the per-pool token bucket every amplifying
  recovery path (retries, hedges, mid-window failover, fanout member
  re-runs) spends from, so a sick pool degrades to one attempt per
  call instead of multiplying its own load (:mod:`.budget`).
- :mod:`.partition` — the gradient-sharding lane:
  partition-index shard math, the head/tail slice rule, loud
  reassembly, window reduction, and the mid-tier aggregator compute
  behind ``PooledArraysClient.evaluate_reduced``.

Everything is observable: ``pftpu_pool_*`` metric families, ``pool.*`` flight-recorder events, and
``pool.evaluate``/``pool.window`` spans that keep a failed-over
call's full replica itinerary in one trace.
"""

from .breaker import CircuitBreaker
from .budget import RetryBudget
from .partition import (
    GradPartition,
    PartitionError,
    Reassembler,
    make_aggregator_compute,
    plan_partitions,
)
from .policies import (
    EwmaLatencyPolicy,
    PowerOfTwoChoicesPolicy,
    RoundRobinPolicy,
    get_policy,
)
from .pool import NodePool, Replica
from .pooled_client import PooledArraysClient

__all__ = [
    "CircuitBreaker",
    "EwmaLatencyPolicy",
    "GradPartition",
    "NodePool",
    "PartitionError",
    "PooledArraysClient",
    "PowerOfTwoChoicesPolicy",
    "Reassembler",
    "Replica",
    "RetryBudget",
    "RoundRobinPolicy",
    "get_policy",
    "make_aggregator_compute",
    "plan_partitions",
]
