"""Routing for the host-federation lane: the gradient-partition rules.

Only :mod:`.partition` is ported (the TCP lane imports it): partition-
index shard math, the head/tail slice rule, loud reassembly, window
reduction, and the mid-tier aggregator compute behind
``TcpArraysClient.evaluate_reduced``.  The JAX package's replica pool,
policies, breaker, retry budget and pooled client are not ported yet.
"""

from .partition import (
    GradPartition,
    PartitionError,
    Reassembler,
    make_aggregator_compute,
    plan_partitions,
)

__all__ = [
    "GradPartition",
    "PartitionError",
    "Reassembler",
    "make_aggregator_compute",
    "plan_partitions",
]
