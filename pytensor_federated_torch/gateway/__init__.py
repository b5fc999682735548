"""Gateway tier: the front door that multiplexes many clients onto the
replica pool.

Three pieces, one package:

- :mod:`.server` — the accept tier: one address speaking the existing
  npwire framing, thousands of downstream connections on one asyncio
  loop, requests coalesced into a few upstream pipelined batch windows
  against a :class:`~..routing.pool.NodePool`.
- :mod:`.fairness` — per-tenant identity (the new wire field, declared
  in :mod:`..service.wire_registry`), token-bucket quotas, and
  deficit-round-robin weighted-fair queueing, so one hog tenant cannot
  starve the rest.
- :mod:`.autoscale` — spawn/drain pool replicas from observed
  queue-depth / EWMA-latency / shed-rate signals, with hysteresis,
  probe-gated warm-up, and graceful drain on the way down.

Port of the JAX package's ``gateway/``: pure asyncio host code, the same
names, error strings and metric families (``pftpu_gateway_*``).  It
needs no ``grpcio``: downstream and upstream it speaks npwire over TCP,
so behind it sit the port's torch nodes — on a CUDA node, each upstream
window runs as one chain-batched kernel launch.
"""

from .autoscale import Autoscaler, ReplicaHandle
from .fairness import (
    OVERLOAD_ERROR_PREFIX,
    TenantFairness,
    TokenBucket,
    WeightedFairQueue,
    is_overload_error,
    overload_error,
)
from .server import GatewayServer, GatewayThread, serve_gateway

__all__ = [
    "Autoscaler",
    "GatewayServer",
    "GatewayThread",
    "OVERLOAD_ERROR_PREFIX",
    "ReplicaHandle",
    "TenantFairness",
    "TokenBucket",
    "WeightedFairQueue",
    "is_overload_error",
    "overload_error",
    "serve_gateway",
]
