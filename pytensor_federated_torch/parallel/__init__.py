"""Shard packing and the sharded evaluator."""

from .packing import ShardedData, pack_shards
from .sharded import FederatedLogp, NoFederatedShards, sharded_compute
